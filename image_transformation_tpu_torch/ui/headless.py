# Copy of image_transformation_tpu/ui/headless.py (host-only; _APPS names this package's apps, and run_app and the CLI pass a device to them).
"""Headless Streamlit stand-in: run the real UI scripts without streamlit.

The reference's primary entry point is ``streamlit run app.py``
(its Dockerfile:30 and app.py:31-324).  Streamlit is an
optional dependency, so this module provides a faithful headless driver
for the same scripts: every widget call resolves against a scripted
value table (falling back to the widget's own default), every display call
is recorded, and ``session_state`` persists across reruns exactly like
Streamlit's top-to-bottom re-execution model.

Usage (tests and CLI):

    st = HeadlessStreamlit(values={"Run macro placement": True, ...})
    run_app("main", st, device="cpu")  # executes image_transformation_tpu_torch.ui.app.main(device="cpu")
    st.session_state[...]        # inspect state
    st.find("image")             # inspect rendered output

``python -m image_transformation_tpu_torch.ui.headless main --device cpu
--set "Ratio W=9"`` runs one pass of the app and prints the render
transcript, making the UI surface exercisable on machines without
streamlit installed. The apps run their pixel work on the device they are
given ("cuda" by default, which raises without a card once a run starts).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence


class StopExecution(Exception):
    """Raised by st.stop(): ends the current script run (as streamlit does)."""


class SessionState(dict):
    """Dict with attribute access, matching st.session_state semantics."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:  # streamlit raises AttributeError here too
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value


@dataclass
class Call:
    """One recorded UI call: ``kind`` is the method name, ``label`` its first
    textual argument (caption/body for display elements)."""

    kind: str
    label: str = ""
    args: tuple = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)
    value: Any = None  # resolved value for widgets

    def __repr__(self) -> str:  # compact transcript line
        v = f" -> {self.value!r}" if self.value is not None else ""
        return f"<{self.kind} {self.label!r}{v}>"


class _Container:
    """Context manager stand-in for columns / expanders / tabs / sidebar.

    Forwards every attribute to the root app so code like
    ``with col: st.number_input(...)`` and ``st.sidebar.slider(...)`` both
    land in one recorder.
    """

    def __init__(self, root: "HeadlessStreamlit", name: str):
        self._root = root
        self._name = name

    def __getattr__(self, attr: str) -> Any:
        return getattr(self._root, attr)

    def __enter__(self) -> "_Container":
        return self

    def __exit__(self, *exc) -> bool:
        return False


class _Slot:
    """st.empty() placeholder: latest status write wins, all are recorded."""

    def __init__(self, root: "HeadlessStreamlit"):
        self._root = root
        self.status: Optional[Call] = None

    def _write(self, kind: str, body: str) -> None:
        self.status = self._root._record(f"empty.{kind}", str(body))

    def info(self, body: str) -> None:
        self._write("info", body)

    def success(self, body: str) -> None:
        self._write("success", body)

    def warning(self, body: str) -> None:
        self._write("warning", body)

    def error(self, body: str) -> None:
        self._write("error", body)


class HeadlessStreamlit:
    """Drop-in ``st`` module object executing the UI without a browser.

    ``values`` maps widget key (preferred) or label to the value the "user"
    set this run; anything unscripted resolves to the widget's default, so a
    bare instance renders the app exactly as it first loads.
    """

    def __init__(self, values: Optional[Dict[str, Any]] = None):
        self.session_state = SessionState()
        self.values: Dict[str, Any] = dict(values or {})
        self.calls: List[Call] = []
        self.sidebar = _Container(self, "sidebar")

    # ------------------------------ introspection ------------------------

    def _record(self, kind: str, label: str = "", *args: Any,
                value: Any = None, **kwargs: Any) -> Call:
        call = Call(kind=kind, label=str(label), args=args, kwargs=kwargs,
                    value=value)
        self.calls.append(call)
        return call

    def find(self, kind: str, contains: Optional[str] = None) -> List[Call]:
        """Recorded calls of ``kind`` (suffix match), optionally filtered by
        substring of the label."""
        out = [c for c in self.calls
               if c.kind == kind or c.kind.endswith("." + kind)]
        if contains is not None:
            out = [c for c in out if contains in c.label]
        return out

    def transcript(self) -> str:
        return "\n".join(repr(c) for c in self.calls)

    def rerun_values(self, values: Optional[Dict[str, Any]] = None) -> None:
        """Start a fresh run: clear the render record (session_state
        persists, as in streamlit) and swap in this run's widget values."""
        self.calls.clear()
        self.values = dict(values or {})

    # ------------------------------ widgets ------------------------------

    def _widget(self, kind: str, label: str, default: Any,
                key: Optional[str] = None, **kwargs: Any) -> Any:
        if key is not None and key in self.values:
            value = self.values[key]
        elif label in self.values:
            value = self.values[label]
        elif key is not None and key in self.session_state:
            # streamlit binds keyed widgets to session_state
            value = self.session_state[key]
        else:
            value = default
        if key is not None:
            self.session_state[key] = value
        self._record(kind, label, value=value, key=key, **kwargs)
        return value

    def text_input(self, label: str, value: str = "", *, key: Optional[str] = None,
                   type: Optional[str] = None, help: Optional[str] = None) -> str:
        return self._widget("text_input", label, value, key=key)

    def text_area(self, label: str, value: str = "", *, height: Optional[int] = None,
                  key: Optional[str] = None) -> str:
        return self._widget("text_area", label, value, key=key)

    @staticmethod
    def _bounded(label, result, min_value, max_value):
        """Enforce real Streamlit's widget invariants: min < max must hold
        (st.slider(0, 0) raises StreamlitAPIException in the real app —
        the faithful driver must catch that class of bug, not mask it),
        and scripted values clamp into range like the real widget would
        never return an out-of-range value."""
        if (
            min_value is not None
            and max_value is not None
            and min_value >= max_value
        ):
            raise ValueError(
                f"widget {label!r}: min_value {min_value!r} must be < "
                f"max_value {max_value!r} (real Streamlit raises here)"
            )
        if result is not None:
            if min_value is not None and result < min_value:
                result = min_value
            if max_value is not None and result > max_value:
                result = max_value
        return result

    def number_input(self, label: str, min_value=None, max_value=None,
                     value=None, step=None, *, key: Optional[str] = None):
        default = value if value is not None else min_value
        got = self._widget("number_input", label, default, key=key)
        return self._bounded(label, got, min_value, max_value)

    def slider(self, label: str, min_value=None, max_value=None, value=None,
               step=None, *, key: Optional[str] = None):
        default = value if value is not None else min_value
        got = self._widget("slider", label, default, key=key)
        return self._bounded(label, got, min_value, max_value)

    def selectbox(self, label: str, options: Sequence[Any], index: int = 0,
                  *, key: Optional[str] = None):
        options = list(options)
        default = options[index] if options else None
        chosen = self._widget("selectbox", label, default, key=key)
        if options and chosen not in options:
            raise ValueError(f"selectbox {label!r}: {chosen!r} not in {options}")
        return chosen

    def radio(self, label: str, options: Sequence[Any] = (), index: int = 0,
              *, key: Optional[str] = None):
        options = list(options)
        default = options[index] if options else None
        return self._widget("radio", label, default, key=key)

    def checkbox(self, label: str, value: bool = False, *,
                 key: Optional[str] = None) -> bool:
        return bool(self._widget("checkbox", label, value, key=key))

    def button(self, label: str, *, key: Optional[str] = None) -> bool:
        # Streamlit buttons are momentary: True only on the run right
        # after the click, and never persisted in session_state — resolve
        # purely from this run's scripted values.
        if key is not None and key in self.values:
            value = bool(self.values[key])
        else:
            value = bool(self.values.get(label, False))
        self._record("button", label, value=value, key=key)
        return value

    # --------------------------- display elements ------------------------

    def set_page_config(self, **kwargs: Any) -> None:
        self._record("set_page_config", kwargs.get("page_title", ""), **kwargs)

    def _display(self, kind: str, body: Any = "", **kwargs: Any) -> None:
        self._record(kind, body, **kwargs)

    def title(self, body: str) -> None:
        self._display("title", body)

    def header(self, body: str) -> None:
        self._display("header", body)

    def subheader(self, body: str) -> None:
        self._display("subheader", body)

    def caption(self, body: str) -> None:
        self._display("caption", body)

    def markdown(self, body: str) -> None:
        self._display("markdown", body)

    def write(self, body: Any) -> None:
        self._display("write", body)

    def info(self, body: str) -> None:
        self._display("info", body)

    def success(self, body: str) -> None:
        self._display("success", body)

    def warning(self, body: str) -> None:
        self._display("warning", body)

    def error(self, body: str) -> None:
        self._display("error", body)

    def json(self, body: Any, *, expanded: bool = True) -> None:
        self._record("json", "", value=body, expanded=expanded)

    def code(self, body: str, language: Optional[str] = None) -> None:
        self._record("code", body, language=language)

    def image(self, image: Any, caption: Optional[str] = None,
              width: Optional[int] = None, *, use_container_width: bool = False) -> None:
        self._record("image", str(image), caption=caption, width=width)

    # ------------------------------ layout -------------------------------

    def columns(self, spec) -> List[_Container]:
        n = spec if isinstance(spec, int) else len(spec)
        self._record("columns", str(spec))
        return [_Container(self, f"column{i}") for i in range(n)]

    def expander(self, label: str, expanded: bool = False) -> _Container:
        self._record("expander", label, expanded=expanded)
        return _Container(self, f"expander:{label}")

    def tabs(self, labels: Sequence[str]) -> List[_Container]:
        self._record("tabs", "|".join(labels))
        return [_Container(self, f"tab:{lbl}") for lbl in labels]

    def empty(self) -> _Slot:
        self._record("empty")
        return _Slot(self)

    # ------------------------------ control ------------------------------

    def stop(self) -> None:
        self._record("stop")
        raise StopExecution()


_APPS = {
    "main": ("image_transformation_tpu_torch.ui.app", "app.py"),
    "agentic": ("image_transformation_tpu_torch.ui.agentic_app", "agentic/app.py"),
}


def run_app(app: str, st: Optional[HeadlessStreamlit] = None,
            values: Optional[Dict[str, Any]] = None,
            device: str = "cuda") -> HeadlessStreamlit:
    """Execute one top-to-bottom pass of a UI script under the headless
    driver, returning the driver for inspection.  Reruns with the same
    ``st`` preserve session_state (call ``st.rerun_values`` between runs).
    The app's ``main`` runs its pixel work on ``device``."""
    import importlib

    if st is None:
        st = HeadlessStreamlit(values)
    elif values is not None:
        st.rerun_values(values)
    module_name, _ = _APPS[app]
    mod = importlib.import_module(module_name)
    prev = mod.st
    mod.st = st
    try:
        mod.main(device=device)
    except StopExecution:
        pass
    finally:
        mod.st = prev
    return st


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="Run a Streamlit UI script headlessly and print its render transcript."
    )
    parser.add_argument("app", choices=sorted(_APPS), help="which UI script")
    parser.add_argument(
        "--set", action="append", default=[], metavar="LABEL=VALUE",
        help="script a widget value (repeatable); VALUE parses as JSON when possible",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="device of the app's runs: 'cuda' (default; raises without a card) or 'cpu'",
    )
    args = parser.parse_args(argv)

    import json

    values: Dict[str, Any] = {}
    for item in args.set:
        label, _, raw = item.partition("=")
        try:
            values[label] = json.loads(raw)
        except json.JSONDecodeError:
            values[label] = raw
    st = run_app(args.app, values=values, device=args.device)
    print(st.transcript())


if __name__ == "__main__":
    main(sys.argv[1:])
