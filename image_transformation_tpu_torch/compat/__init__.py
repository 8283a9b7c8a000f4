"""The reference library's public modules on the port (counterparts of the
repository's root shims ``compositor.py``, ``background_resizing.py``,
``layout_constraints.py`` and ``api_client.py``): the reference
signatures, PIL in and PIL out, with a ``device`` keyword where pixels are
computed ("cuda" by default, which raises without a card; "cpu")."""
