# Copy of image_transformation_tpu/vlm/client.py (host-only; imports rewritten to this package).
"""VLM client seam: Nebius (OpenAI SDK) / Ollama / hermetic fakes.

Interface parity with the reference api_client.py
(reference/api_client.py:28-529): the message protocol is
``{"role", "content", "images": [b64, ...]}``, responses normalize to
``{"message": {"content": str}}``, model defaults match
(Qwen/Qwen2.5-VL-72B-Instruct on Nebius, llava:13b on Ollama), "auto"
resolves by key/package availability, and a lightweight .env loader fills
NEBIUS_API_KEY.

Differences from the reference (deliberate):
- ``tools``/``tool_choice`` are actually forwarded to the provider and
  ``tool_calls`` surface in the normalized response (the reference silently
  dropped them, making its agentic micro-agent dead code — SURVEY.md
  §2.6.2);
- :class:`FakeClient` provides canned/scripted responses so the whole
  iterate loop runs hermetically (tests, benchmarks, fault injection);
- when the ``openai``/``ollama`` SDKs are absent, both backends fall back
  to a dependency-free raw-HTTP transport (urllib) speaking the same wire
  protocols (OpenAI chat-completions REST for Nebius,
  reference/api_client.py:154-221; Ollama's /api/chat,
  reference/api_client.py:223-261), so the framework deploys without
  either SDK and the adapters are testable against a local HTTP server.

This module is pure host I/O — the device never blocks on it; the
orchestrator overlaps VLM round-trips with device compose via async
dispatch (see pipeline.run).
"""

from __future__ import annotations

import base64
import io
import json
import os
import re
import urllib.error
import urllib.request
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union

from PIL import Image

try:
    from openai import OpenAI

    OPENAI_AVAILABLE = True
except ImportError:  # pragma: no cover
    OPENAI_AVAILABLE = False

try:
    import ollama

    OLLAMA_AVAILABLE = True
except ImportError:
    OLLAMA_AVAILABLE = False

NEBIUS_BASE_URL = "https://api.studio.nebius.com/v1/"
NEBIUS_DEFAULT_VLM = "Qwen/Qwen2.5-VL-72B-Instruct"
NEBIUS_DEFAULT_TEXT = "openai/gpt-oss-20b"
OLLAMA_DEFAULT_VLM = "llava:13b"
OLLAMA_DEFAULT_TEXT = "mistral:7b"
OLLAMA_DEFAULT_HOST = "http://localhost:11434"


def http_post_json(url: str, payload: Dict[str, Any],
                   headers: Optional[Dict[str, str]] = None,
                   timeout: float = 120.0) -> Dict[str, Any]:
    """POST a JSON body, return the parsed JSON response (stdlib only)."""
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode("utf-8"),
        method="POST",
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        try:
            detail = e.read().decode("utf-8", "replace")[:2000]
        except Exception:
            detail = ""
        raise RuntimeError(f"HTTP {e.code} from {url}: {detail}") from e


def _ollama_server_reachable(host: str, timeout: float = 1.0) -> bool:
    """Quick liveness probe (GET /api/tags) for auto-mode backend selection
    when the ollama SDK is absent but a server may be running."""
    try:
        req = urllib.request.Request(
            host.rstrip("/") + "/api/tags", method="GET"
        )
        with urllib.request.urlopen(req, timeout=timeout):
            return True
    except Exception:
        return False


def load_dotenv_if_present(extra_dirs: Optional[List[Path]] = None) -> None:
    """Set env vars from the first .env found (cwd, package dir, repo root);
    existing variables are never overridden."""
    candidates = [Path.cwd() / ".env"]
    here = Path(__file__).resolve()
    candidates += [here.parent / ".env", here.parent.parent / ".env",
                   here.parent.parent.parent / ".env"]
    for d in extra_dirs or []:
        candidates.append(Path(d) / ".env")
    try:
        for p in candidates:
            if not p.exists():
                continue
            for raw in p.read_text(encoding="utf-8").splitlines():
                line = raw.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                k, v = line.split("=", 1)
                key = k.strip()
                val = v.strip().strip('"').strip("'")
                if key and key not in os.environ:
                    os.environ[key] = val
            break
    except Exception:
        pass


def encode_pil_b64_png(img: Image.Image) -> str:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("utf-8")


def prepare_image_b64_jpeg(image_path: Union[str, Path], max_side: int = 512) -> str:
    """Downscale longest side <= max_side, JPEG q85, base64 — the reference's
    transport-size reduction for classification images."""
    im = Image.open(image_path).convert("RGB")
    w, h = im.size
    if max(w, h) > max_side:
        s = max_side / float(max(w, h))
        im = im.resize((max(1, int(w * s)), max(1, int(h * s))), Image.LANCZOS)
    buf = io.BytesIO()
    im.save(buf, format="JPEG", quality=85)
    return base64.b64encode(buf.getvalue()).decode("utf-8")


def scan_json_object(text: str) -> Optional[Dict[str, Any]]:
    """Tolerant JSON-object scan, the ONE extractor for LLM replies:
    fenced blocks anywhere in the text are tried first (models preface
    them with prose), then a balanced-brace scan returns the FIRST
    parseable object. A greedy first-{-to-last-} slice would splice in
    trailing prose braces like "tune {gap_px} later" and fail on output
    the loop should survive. Returns None when nothing parses."""

    def first_object(s: str):
        depth = 0
        start = -1
        for i, ch in enumerate(s):
            if ch == "{":
                if depth == 0:
                    start = i
                depth += 1
            elif ch == "}" and depth:
                depth -= 1
                if depth == 0 and start != -1:
                    try:
                        obj = json.loads(s[start : i + 1])
                    except json.JSONDecodeError:
                        start = -1  # brace inside prose; keep scanning
                        continue
                    if isinstance(obj, dict):
                        return obj
        return None

    s = text.strip()
    candidates = []
    parts = s.split("```")
    for k in range(1, len(parts), 2):  # fenced block contents
        block = parts[k]
        if block.startswith("json"):
            block = block[4:]
        candidates.append(block.strip())
    candidates.append(s)
    for cand in candidates:
        obj = first_object(cand)
        if obj is not None:
            return obj
    return None


def extract_json_from_content(content: str) -> Dict[str, Any]:
    """Best-effort JSON extraction: direct parse, then the tolerant scan.
    Returns the reference's error-dict sentinel when nothing parses."""
    try:
        return json.loads(content.strip())
    except Exception:
        pass
    obj = scan_json_object(content)
    if obj is not None:
        return obj
    return {"error": "Could not parse JSON from response", "content": content}


class APIClient:
    """Unified chat-completion client over Nebius or Ollama."""

    def __init__(self, api_type: str = "auto", api_key: Optional[str] = None,
                 base_url: Optional[str] = None):
        self.api_type = api_type
        self.api_key = api_key
        self.nebius_client = None  # OpenAI SDK client when available
        self._nebius_key: Optional[str] = None
        load_dotenv_if_present()

        if api_type == "auto":
            # A key is enough for Nebius: without the openai SDK the raw-HTTP
            # transport takes over (the reference also required the package,
            # reference/api_client.py:48-54).
            if self.api_key or os.getenv("NEBIUS_API_KEY"):
                self.api_type = "nebius"
            elif OLLAMA_AVAILABLE or _ollama_server_reachable(
                base_url or os.getenv("OLLAMA_HOST") or OLLAMA_DEFAULT_HOST
            ):
                # The SDK-free raw-HTTP transport serves api_type="ollama"
                # without the python package, so auto mode must also select
                # it when only a running server is present.
                self.api_type = "ollama"
            else:
                raise RuntimeError(
                    "Neither Nebius API nor Ollama is available. Set "
                    "NEBIUS_API_KEY, or install/run Ollama."
                )

        if self.api_type == "nebius":
            key = self.api_key or os.getenv("NEBIUS_API_KEY")
            if not key:
                raise RuntimeError("NEBIUS_API_KEY environment variable not set")
            self._nebius_key = key
            self.nebius_base_url = (
                base_url or os.getenv("NEBIUS_BASE_URL") or NEBIUS_BASE_URL
            )
            if not self.nebius_base_url.endswith("/"):
                self.nebius_base_url += "/"
            if OPENAI_AVAILABLE:
                self.nebius_client = OpenAI(
                    base_url=self.nebius_base_url, api_key=key
                )
        elif self.api_type == "ollama":
            self.ollama_host = (
                base_url or os.getenv("OLLAMA_HOST") or OLLAMA_DEFAULT_HOST
            ).rstrip("/")

    # ---------------- reference-surface helper methods ----------------

    def _load_dotenv_if_present(self) -> None:
        load_dotenv_if_present()

    def _prepare_image_b64_for_api(self, image_path, max_side: int = 512) -> str:
        return prepare_image_b64_jpeg(image_path, max_side)

    def _encode_image_to_b64(self, img: Image.Image) -> str:
        return encode_pil_b64_png(img)

    def _extract_json_from_content(self, content: str) -> Dict[str, Any]:
        return extract_json_from_content(content)

    # ------------------------------ core ------------------------------

    def chat_completion(
        self,
        messages: List[Dict[str, Any]],
        model: Optional[str] = None,
        temperature: float = 0.0,
        max_tokens: Optional[int] = None,
        format: Optional[str] = None,
        tools: Optional[List[Dict]] = None,
        tool_choice: Optional[Union[str, Dict]] = None,
        **kwargs,
    ) -> Dict[str, Any]:
        """Send a chat completion; returns {"message": {"content": str,
        "tool_calls": [...]?}} regardless of provider."""
        if self.api_type == "nebius":
            return self._nebius(messages, model, temperature, max_tokens,
                                tools, tool_choice, **kwargs)
        if self.api_type == "ollama":
            return self._ollama(messages, model, temperature, max_tokens,
                                format, tools, **kwargs)
        raise RuntimeError(f"Unknown API type: {self.api_type}")

    @staticmethod
    def _to_openai_messages(messages: List[Dict[str, Any]]) -> List[Dict]:
        out: List[Dict] = []
        for msg in messages:
            role = msg["role"]
            if role == "user" and msg.get("images"):
                parts: List[Dict] = [{"type": "text", "text": msg["content"]}]
                for img_b64 in msg["images"]:
                    parts.append({
                        "type": "image_url",
                        "image_url": {"url": f"data:image/jpeg;base64,{img_b64}"},
                    })
                out.append({"role": "user", "content": parts})
            else:
                out.append({"role": role, "content": msg["content"]})
        return out

    def _nebius(self, messages, model, temperature, max_tokens, tools,
                tool_choice, **kwargs) -> Dict[str, Any]:
        params: Dict[str, Any] = {
            "model": model or NEBIUS_DEFAULT_VLM,
            "messages": self._to_openai_messages(messages),
            "temperature": temperature,
        }
        if max_tokens:
            params["max_tokens"] = max_tokens
        if tools:
            params["tools"] = tools
            if tool_choice is not None:
                params["tool_choice"] = tool_choice
        if self.nebius_client is not None:
            response = self.nebius_client.chat.completions.create(**params)
            choice = response.choices[0].message
            content = choice.content or ""
            tool_calls = [
                {
                    "id": tc.id,
                    "function": {
                        "name": tc.function.name,
                        "arguments": tc.function.arguments,
                    },
                }
                for tc in (getattr(choice, "tool_calls", None) or [])
            ]
        else:
            # SDK-free transport: same OpenAI chat-completions REST protocol
            # the SDK speaks (POST {base}/chat/completions, bearer auth).
            payload = http_post_json(
                self.nebius_base_url + "chat/completions",
                params,
                headers={"Authorization": f"Bearer {self._nebius_key}"},
            )
            choice = (payload.get("choices") or [{}])[0].get("message") or {}
            content = choice.get("content") or ""
            tool_calls = [
                {
                    "id": tc.get("id"),
                    "function": {
                        "name": (tc.get("function") or {}).get("name"),
                        "arguments": (tc.get("function") or {}).get("arguments"),
                    },
                }
                for tc in (choice.get("tool_calls") or [])
            ]
        normalized: Dict[str, Any] = {"message": {"content": content}}
        if tool_calls:
            normalized["message"]["tool_calls"] = tool_calls
        return normalized

    def _ollama(self, messages, model, temperature, max_tokens, format,
                tools, **kwargs) -> Dict[str, Any]:
        params: Dict[str, Any] = {
            "model": model or OLLAMA_DEFAULT_VLM,
            "messages": messages,
            "stream": False,
            "options": {
                "temperature": temperature,
                "top_p": kwargs.get("top_p", 0.1),
                "num_predict": max_tokens or kwargs.get("num_predict", 1024),
            },
        }
        if format:
            params["format"] = format
        if tools:
            params["tools"] = tools
        if "keep_alive" in kwargs:
            params["keep_alive"] = kwargs["keep_alive"]
        try:
            if OLLAMA_AVAILABLE:
                return ollama.chat(**params)
            # SDK-free transport: Ollama's native /api/chat endpoint already
            # answers in the normalized {"message": {...}} shape.
            return http_post_json(self.ollama_host + "/api/chat", params)
        except Exception as e:
            if any(tok in str(e) for tok in ("not found", "status code: 404", "HTTP 404")):
                raise RuntimeError(
                    f"Ollama model not found. Pull it first: 'ollama pull "
                    f"{params['model']}'. Ensure 'ollama serve' is running."
                )
            raise

    # ------------------------ high-level helpers ------------------------

    def classify_object(self, object_path, system_instructions: str,
                        user_prompt: str, max_seconds: int = 35,
                        max_side: int = 512):
        """Classify one cutout; returns (predicted_class, label)."""
        image_b64 = prepare_image_b64_jpeg(object_path, max_side)
        messages = [
            {"role": "system", "content": system_instructions},
            {"role": "user", "content": user_prompt, "images": [image_b64]},
        ]
        if self.api_type == "nebius":
            model, temp, mt = NEBIUS_DEFAULT_VLM, 0.0, 120000
        else:
            model, temp, mt = OLLAMA_DEFAULT_VLM, 0, 12000
        try:
            response = self.chat_completion(
                messages=messages, model=model, temperature=temp, max_tokens=mt,
                format="json" if self.api_type == "ollama" else None,
            )
            content = response.get("message", {}).get("content", "").strip()
            return self._parse_classification(content)
        except Exception as e:
            print(f"  .. API error on {Path(object_path).name}: {e}", flush=True)
            return "unknown", "unknown"

    @staticmethod
    def _parse_classification(content: str):
        try:
            data = json.loads(content)
            return (
                str(data.get("class", "unknown")).strip().lower(),
                str(data.get("label", "unknown")).strip(),
            )
        except Exception:
            m = re.search(r'\{[^}]*"class"[^}]*"label"[^}]*\}', content)
            if m:
                try:
                    data = json.loads(m.group())
                    return (
                        str(data.get("class", "unknown")).strip().lower(),
                        str(data.get("label", "unknown")).strip(),
                    )
                except Exception:
                    pass
        return "unknown", "unknown"

    def analyze_image_for_objects(self, image_path, prompt: str,
                                  model: Optional[str] = None) -> str:
        with open(image_path, "rb") as f:
            image_b64 = base64.b64encode(f.read()).decode("utf-8")
        messages = [{"role": "user", "content": prompt, "images": [image_b64]}]
        model = model or self._default_vlm()
        return self.chat_completion(messages=messages, model=model)["message"]["content"]

    def generate_layout(self, contact_sheet: Image.Image, background_path,
                        results_json_path, ratio: str, prompt: str,
                        model: Optional[str] = None) -> Dict[str, Any]:
        contact_b64 = encode_pil_b64_png(contact_sheet)
        with open(background_path, "rb") as f:
            background_b64 = base64.b64encode(f.read()).decode("utf-8")
        messages = [
            {"role": "system", "content": (
                "You are a JSON generator. Output ONLY valid JSON matching the "
                "exact schema provided. No markdown, no explanations, no extra text."
            )},
            {"role": "user", "content": prompt, "images": [contact_b64, background_b64]},
        ]
        model = model or self._default_vlm()
        content = self.chat_completion(messages=messages, model=model)["message"]["content"].strip()
        return extract_json_from_content(content)

    def critique_layout(self, image_path, prompt: str,
                        model: Optional[str] = None) -> Dict[str, Any]:
        with open(image_path, "rb") as f:
            image_b64 = base64.b64encode(f.read()).decode("utf-8")
        messages = [{"role": "user", "content": prompt, "images": [image_b64]}]
        model = model or self._default_vlm()
        content = self.chat_completion(messages=messages, model=model)["message"]["content"]
        return extract_json_from_content(content)

    def translate_critique(self, critique: str, current_params: Dict[str, Any],
                           prompt: str, model: Optional[str] = None) -> Dict[str, Any]:
        messages = [{"role": "user", "content": prompt}]
        if model is None:
            model = NEBIUS_DEFAULT_TEXT if self.api_type == "nebius" else OLLAMA_DEFAULT_TEXT
        content = self.chat_completion(messages=messages, model=model)["message"]["content"]
        return extract_json_from_content(content)

    def _default_vlm(self) -> str:
        return NEBIUS_DEFAULT_VLM if self.api_type == "nebius" else OLLAMA_DEFAULT_VLM


class FakeClient:
    """Hermetic scripted client for tests, benchmarks and fault injection.

    ``script`` is a list of responses returned in order (strings become
    {"message": {"content": str}}); a callable receives the kwargs and
    returns a response dict. The last entry repeats once exhausted.
    """

    api_type = "fake"

    def __init__(self, script: List[Union[str, Dict, Callable]], record: bool = True):
        if not script:
            raise ValueError("FakeClient needs at least one scripted response")
        self.script = list(script)
        self.calls: List[Dict[str, Any]] = []
        self.record = record
        self._cursor = 0

    def chat_completion(self, messages: List[Dict[str, Any]], **kwargs) -> Dict[str, Any]:
        if self.record:
            self.calls.append({"messages": messages, **kwargs})
        entry = self.script[min(self._cursor, len(self.script) - 1)]
        self._cursor += 1
        if callable(entry):
            entry = entry(messages=messages, **kwargs)
        if isinstance(entry, str):
            return {"message": {"content": entry}}
        if isinstance(entry, Exception):
            raise entry
        return entry


_api_clients: Dict[str, Any] = {}
_fake_factory: Optional[Callable[[], Any]] = None


def register_fake_client(factory: Optional[Callable[[], Any]]) -> None:
    """Route get_api_client() to a fake (pass None to restore real clients).

    The orchestrator and UIs resolve clients exclusively through
    get_api_client, so this one seam makes the entire pipeline hermetic.
    """
    global _fake_factory
    _fake_factory = factory
    _api_clients.clear()


def get_api_client(api_type: str = "auto", api_key: Optional[str] = None):
    """Get or create a cached client keyed by (api_type, api_key)."""
    if _fake_factory is not None:
        key = f"fake:{api_type}:{api_key or ''}"
        if key not in _api_clients:
            _api_clients[key] = _fake_factory()
        return _api_clients[key]
    cache_key = f"{api_type}:{api_key or ''}"
    client = _api_clients.get(cache_key)
    if client is None:
        client = APIClient(api_type=api_type, api_key=api_key)
        _api_clients[cache_key] = client
    return client
