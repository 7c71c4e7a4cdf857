"""LLM chat clients.

Reference: pkg/llm — `Client{Chat, ChatWithImages}` (client.go:17),
OpenAI-compatible implementation (client.go:30-256), Gemini
generateContent implementation (gemini_client.go). Network-gated: in
zero-egress environments dependents (gardener advanced mode, LLM compile
fields, proxy rewriting) fall back to their deterministic paths, exactly
like the reference running with a nil client (SURVEY §4.7)."""

from __future__ import annotations

import base64
import json
import logging
from typing import Optional, Protocol, Sequence

log = logging.getLogger("kektordb.llm")


class LLMClient(Protocol):
    def chat(self, system: str, user: str, **kw) -> str: ...
    def chat_with_images(self, system: str, user: str,
                         images: Sequence[bytes], **kw) -> str: ...


class OpenAICompatClient:
    """Works against OpenAI, vLLM, llama.cpp, LM Studio, Ollama(/v1)."""

    def __init__(self, base_url: str, model: str,
                 api_key: Optional[str] = None, timeout: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.api_key = api_key
        self.timeout = timeout

    def _post(self, messages: list[dict], **kw) -> str:
        import requests
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        body = {"model": self.model, "messages": messages}
        body.update(kw)
        r = requests.post(f"{self.base_url}/chat/completions", json=body,
                          headers=headers, timeout=self.timeout)
        r.raise_for_status()
        return r.json()["choices"][0]["message"]["content"]

    def chat(self, system: str, user: str, **kw) -> str:
        msgs = []
        if system:
            msgs.append({"role": "system", "content": system})
        msgs.append({"role": "user", "content": user})
        return self._post(msgs, **kw)

    def chat_with_images(self, system: str, user: str,
                         images: Sequence[bytes], **kw) -> str:
        content = [{"type": "text", "text": user}]
        for img in images:
            b64 = base64.b64encode(img).decode()
            content.append({"type": "image_url", "image_url": {
                "url": f"data:image/png;base64,{b64}"}})
        msgs = []
        if system:
            msgs.append({"role": "system", "content": system})
        msgs.append({"role": "user", "content": content})
        return self._post(msgs, **kw)


class GeminiClient:
    """generateContent API (pkg/llm/gemini_client.go)."""

    def __init__(self, api_key: str, model: str = "gemini-2.0-flash",
                 timeout: float = 120.0):
        self.api_key = api_key
        self.model = model
        self.timeout = timeout

    def _post(self, parts: list[dict], system: str) -> str:
        import requests
        url = (f"https://generativelanguage.googleapis.com/v1beta/models/"
               f"{self.model}:generateContent?key={self.api_key}")
        body = {"contents": [{"role": "user", "parts": parts}]}
        if system:
            body["systemInstruction"] = {"parts": [{"text": system}]}
        r = requests.post(url, json=body, timeout=self.timeout)
        r.raise_for_status()
        return r.json()["candidates"][0]["content"]["parts"][0]["text"]

    def chat(self, system: str, user: str, **kw) -> str:
        return self._post([{"text": user}], system)

    def chat_with_images(self, system: str, user: str,
                         images: Sequence[bytes], **kw) -> str:
        parts = [{"text": user}]
        for img in images:
            parts.append({"inlineData": {
                "mimeType": "image/png",
                "data": base64.b64encode(img).decode()}})
        return self._post(parts, system)


def clean_llm_json(text: str) -> Optional[dict | list]:
    """Robust JSON extraction from LLM output (the reference's JSON-cleaning
    helpers, gardener.go:37-128): strips code fences, finds the first
    balanced object/array."""
    text = text.strip()
    if text.startswith("```"):
        lines = text.split("\n")
        text = "\n".join(lines[1:-1] if lines[-1].strip() == "```"
                         else lines[1:])
    for opener, closer in (("{", "}"), ("[", "]")):
        start = text.find(opener)
        if start < 0:
            continue
        depth = 0
        in_str = False
        esc = False
        for i in range(start, len(text)):
            c = text[i]
            if esc:
                esc = False
                continue
            if c == "\\":
                esc = True
            elif c == '"':
                in_str = not in_str
            elif not in_str:
                if c == opener:
                    depth += 1
                elif c == closer:
                    depth -= 1
                    if depth == 0:
                        try:
                            return json.loads(text[start:i + 1])
                        except ValueError:
                            break
    return None
