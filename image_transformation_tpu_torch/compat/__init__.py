"""The reference library's public modules on the port, counterparts of the
repository's root shims: ``compositor``, ``background_resizing``,
``layout_constraints``, ``api_client``, ``macro_placement_test``,
``utils.timing``, ``utils.labels`` and the ``agentic`` package with its
``graph``, ``models``, ``nodes``, ``state``, ``tools`` and ``workflow``
modules. Each carries the root shim's names and signatures, PIL in and PIL
out, with a ``device`` keyword where pixels are computed ("cuda" by
default, which raises without a card; "cpu")."""
