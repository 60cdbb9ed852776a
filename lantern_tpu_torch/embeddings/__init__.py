"""Embedding generation runtimes — parity with lantern_cli embeddings (R4)
and lantern_extras' SQL embedding functions (X2).

The reference exposes three runtimes behind one trait
(core/runtime.rs:18-28): Ort (local ONNX models), OpenAi, Cohere — plus SQL
fns text_embedding/llm_embedding/get_available_runtimes/get_available_models
(embeddings.rs:129-221).

Here the registry holds:
- "hash":  deterministic feature-hashing embedder (always available, no
           weights needed — the test/default runtime in a zero-egress env)
- "local": transformers-based runtime for any locally present HF model dir
           (the Ort analog); ``LocalTransformerRuntime`` and
           ``LocalVisionRuntime`` run their model on ``device`` (default
           ``cuda``, through ``resolve_device``: they raise without a card
           and run on the host only when ``device="cpu"`` is named)
- "openai"/"cohere": REST runtimes (urllib; base_url overridable so tests
           can point them at a mock server); they and "hash" do no device
           work
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import urllib.request

import numpy as np

from lantern_tpu_torch import resolve_device

_RUNTIMES = ("hash", "local", "onnx", "openai", "cohere")

# model name -> (runtime, dim); the reference registers ~17 ONNX models
# (ort_runtime.rs:284-302); ours register lazily + these defaults
KNOWN_MODELS = {
    "hash": ("hash", 128),
    "hash-384": ("hash", 384),
    "hash-768": ("hash", 768),
    "text-embedding-3-small": ("openai", 1536),
    "text-embedding-3-large": ("openai", 3072),
    "text-embedding-ada-002": ("openai", 1536),
    "embed-english-v3.0": ("cohere", 1024),
    "embed-multilingual-v3.0": ("cohere", 1024),
}

# The reference's local-model registry (ort_runtime.rs:284-302), same names
# so `get_available_models()` matches; served here by the "onnx" runtime when
# onnxruntime is installed, else by LocalTransformerRuntime on HF weights.
# name -> (dim, pooling, visual)
ONNX_MODELS = {
    "clip/ViT-B-32-textual": (512, "cls", False),
    "clip/ViT-B-32-visual": (512, "cls", True),
    "BAAI/bge-small-en": (384, "cls", False),
    "BAAI/bge-base-en": (768, "cls", False),
    "BAAI/bge-large-en": (1024, "cls", False),
    "BAAI/bge-m3": (1024, "cls", False),
    "intfloat/e5-base-v2": (768, "cls", False),
    "intfloat/e5-large-v2": (1024, "cls", False),
    "llmrails/ember-v1": (1024, "cls", False),
    "thenlper/gte-base": (768, "cls", False),
    "thenlper/gte-large": (1024, "cls", False),
    "microsoft/all-MiniLM-L12-v2": (384, "cls", False),
    "microsoft/all-mpnet-base-v2": (768, "cls", False),
    "transformers/multi-qa-mpnet-base-dot-v1": (768, "cls", False),
    "jinaai/jina-embeddings-v2-small-en": (512, "mean", False),
    "jinaai/jina-embeddings-v2-base-en": (768, "mean", False),
    "naver/splade-v3": (30522, "relu_log_max", False),
}


def get_available_runtimes() -> list[str]:
    return list(_RUNTIMES)


def get_available_models() -> list[dict]:
    """Model catalog (SQL fn get_available_models parity,
    embeddings.rs:129-221 + ort_runtime.rs:1032-1042 textual/visual split)."""
    out = [
        {"name": name, "runtime": rt, "dim": dim, "visual": False}
        for name, (rt, dim) in KNOWN_MODELS.items()
    ]
    out += [
        {"name": name, "runtime": "onnx", "dim": dim, "visual": visual,
         "pooling": pooling}
        for name, (dim, pooling, visual) in ONNX_MODELS.items()
    ]
    return out


_TOKEN_RE = re.compile(r"[a-z0-9]+")


class HashRuntime:
    """Deterministic feature-hashing embedding (cosine-friendly).

    Tokenizes, hashes each token into `dim` buckets with a signed value,
    l2-normalizes. Stable across processes; useful for tests, demos, and
    as a no-dependency BM25-ish dense baseline.
    """

    def __init__(self, dim: int = 128):
        self.dim = dim

    def process(self, texts: list[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, text in enumerate(texts):
            for tok in _TOKEN_RE.findall(text.lower()):
                h = hashlib.blake2b(tok.encode(), digest_size=8).digest()
                v = int.from_bytes(h, "little")
                bucket = v % self.dim
                sign = 1.0 if (v >> 32) & 1 else -1.0
                out[i, bucket] += sign
            norm = float(np.linalg.norm(out[i]))
            if norm > 0:
                out[i] /= norm
        return out

    def completion(self, prompt: str, model: str = "hash",
                   system: str | None = None) -> str:
        """Deterministic completion stand-in (zero-egress test runtime): the
        daemon's completion-job plumbing (add_completion_job analog,
        lantern_extras/src/daemon.rs:121-227) is what's under test, not a
        model."""
        digest = hashlib.blake2b(
            f"{system or ''}\x00{prompt}".encode(), digest_size=8
        ).hexdigest()
        return f"completion:{digest}"


def _load_pretrained(model_path: str):
    """(model, tokenizer) of a local HF model dir."""
    from transformers import AutoModel, AutoTokenizer  # lazy import

    return (AutoModel.from_pretrained(model_path),
            AutoTokenizer.from_pretrained(model_path))


def _on(enc, device):
    """A tokenizer's or processor's tensors moved to ``device``."""
    return {k: v.to(device) for k, v in enc.items()}


class LocalTransformerRuntime:
    """Local HF-transformers embedding runtime (the reference's Ort analog).

    Requires model weights present on disk (zero-egress environment), or a
    ``model`` and ``tokenizer`` given. The model and every input run on
    ``device`` (default ``cuda``; raises without a card; the CPU only when
    named); results come back as host arrays.
    Pooling modes mirror ort_runtime.rs:31-134: "mean" (masked mean over the
    last hidden state), "cls" (first token), "relu_log_max" (SPLADE-style
    log(1+relu) max-pool). ``batch_size=0`` enables dynamic batch sizing
    from available memory (ort_runtime.rs:318's free-memory threshold).
    """

    POOLINGS = ("mean", "cls", "relu_log_max")

    def __init__(self, model_path: str | None = None, device=None,
                 batch_size: int = 32, pooling: str = "mean",
                 model=None, tokenizer=None, max_length: int = 512):
        if pooling not in self.POOLINGS:
            raise ValueError(f"pooling {pooling!r}; expected {self.POOLINGS}")
        self.device = resolve_device(device)
        if model is not None and tokenizer is not None:
            self.model, self.tokenizer = model, tokenizer
        else:
            self.model, self.tokenizer = _load_pretrained(model_path)
        self.model = self.model.eval().to(self.device)
        self.pooling = pooling
        self.max_length = max_length
        self.batch_size = batch_size or self._dynamic_batch_size()

    def _dynamic_batch_size(self) -> int:
        """Size batches from the free memory of the device the model runs
        on, the card's (``torch.cuda.mem_get_info``) or the host's, at the
        reference's 80% threshold (ort_runtime.rs:318)."""
        if self.device.type == "cuda":
            import torch

            avail, _ = torch.cuda.mem_get_info(self.device)
        else:
            try:
                avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
            except (ValueError, OSError, AttributeError):
                return 32
        cfg = getattr(self.model, "config", None)
        hidden = getattr(cfg, "hidden_size", 768)
        layers = getattr(cfg, "num_hidden_layers", 12) or 1
        # rough activation footprint per sequence (f32)
        per_seq = self.max_length * hidden * (layers + 2) * 4
        usable = int(avail * 0.8)
        return max(1, min(512, usable // max(per_seq, 1)))

    def _pool(self, hidden, mask):
        import torch

        if self.pooling == "cls":
            return hidden[:, 0, :]
        if self.pooling == "relu_log_max":
            act = torch.log1p(torch.relu(hidden))
            act = act.masked_fill(~mask.bool(), float("-inf"))
            return act.max(dim=1).values
        maskf = mask.float()
        return (hidden * maskf).sum(1) / maskf.sum(1).clamp(min=1e-9)

    def process(self, texts: list[str]) -> np.ndarray:
        import torch

        outs = []
        for i in range(0, len(texts), self.batch_size):
            batch = texts[i : i + self.batch_size]
            enc = _on(self.tokenizer(batch, padding=True, truncation=True,
                                     max_length=self.max_length,
                                     return_tensors="pt"), self.device)
            with torch.no_grad():
                hidden = self.model(**enc).last_hidden_state
            pooled = self._pool(hidden, enc["attention_mask"].unsqueeze(-1))
            outs.append(pooled.cpu().numpy().astype(np.float32))
        return np.concatenate(outs)


class LocalVisionRuntime:
    """Local image-embedding runtime — the CLIP-visual analog
    (ort_runtime.rs:286,673 process_image_clip; input_image_size 224).

    Takes a CLIP-style vision model + processor (injectable for offline
    tests; otherwise loaded from a local HF model dir). The model and its
    inputs run on ``device`` (default ``cuda``; raises without a card; the
    CPU only when named). ``process`` accepts PIL images, numpy HWC uint8
    arrays, or raw bytes.
    """

    def __init__(self, model_path: str | None = None, batch_size: int = 16,
                 model=None, processor=None, device=None):
        self.device = resolve_device(device)
        if model is not None and processor is not None:
            self.model, self.processor = model, processor
        else:
            from transformers import AutoImageProcessor, AutoModel  # lazy

            self.processor = AutoImageProcessor.from_pretrained(model_path)
            self.model = AutoModel.from_pretrained(model_path)
        self.model = self.model.eval().to(self.device)
        self.batch_size = batch_size

    @staticmethod
    def _decode(img):
        if isinstance(img, (bytes, bytearray)):
            import io

            from PIL import Image

            return Image.open(io.BytesIO(img)).convert("RGB")
        return img

    def process(self, images: list) -> np.ndarray:
        import torch

        outs = []
        for i in range(0, len(images), self.batch_size):
            batch = [self._decode(im) for im in images[i : i + self.batch_size]]
            enc = _on(self.processor(images=batch, return_tensors="pt"),
                      self.device)
            with torch.no_grad():
                out = self.model(**enc)
            # CLIP vision models expose pooler_output; generic ViTs: CLS token
            pooled = getattr(out, "pooler_output", None)
            if pooled is None:
                pooled = out.last_hidden_state[:, 0, :]
            outs.append(pooled.cpu().numpy().astype(np.float32))
        return np.concatenate(outs)


class OnnxRuntime:
    """ONNX embedding runtime (the reference's Ort runtime, ort_runtime.rs).

    Gated on ``onnxruntime`` being installed — this environment ships
    without it, so construction raises a clear error; the registered model
    catalog (ONNX_MODELS) and the pooling implementations are shared with
    LocalTransformerRuntime, which serves the same models from HF weights.
    """

    def __init__(self, model_path: str, tokenizer_path: str | None = None,
                 pooling: str = "cls", batch_size: int = 32,
                 max_length: int = 512):
        try:
            import onnxruntime  # noqa: F401
        except ImportError as e:  # pragma: no cover - env has no onnxruntime
            raise RuntimeError(
                "onnxruntime is not installed; use the 'local' runtime "
                "(transformers backend) for the same models"
            ) from e
        import onnxruntime as ort
        from transformers import AutoTokenizer

        self.session = ort.InferenceSession(
            model_path, providers=["CPUExecutionProvider"]
        )
        self.tokenizer = AutoTokenizer.from_pretrained(
            tokenizer_path or os.path.dirname(model_path)
        )
        self.pooling = pooling
        self.batch_size = batch_size
        self.max_length = max_length

    def process(self, texts: list[str]) -> np.ndarray:
        outs = []
        for i in range(0, len(texts), self.batch_size):
            enc = self.tokenizer(
                texts[i : i + self.batch_size], padding=True, truncation=True,
                max_length=self.max_length, return_tensors="np",
            )
            feeds = {
                k: v.astype(np.int64)
                for k, v in enc.items()
                if k in {x.name for x in self.session.get_inputs()}
            }
            hidden = self.session.run(None, feeds)[0]
            mask = enc["attention_mask"][:, :, None].astype(np.float32)
            if self.pooling == "cls":
                pooled = hidden[:, 0, :]
            elif self.pooling == "relu_log_max":
                act = np.log1p(np.maximum(hidden, 0))
                act = np.where(mask > 0, act, -np.inf)
                pooled = act.max(axis=1)
            else:
                pooled = (hidden * mask).sum(1) / np.maximum(mask.sum(1), 1e-9)
            outs.append(pooled.astype(np.float32))
        return np.concatenate(outs)


class _RestRuntime:
    """Shared REST embedding runtime (OpenAi/Cohere parity, urllib-based)."""

    def __init__(self, api_key: str, base_url: str, batch_size: int = 128):
        self.api_key = api_key
        self.base_url = base_url.rstrip("/")
        self.batch_size = batch_size

    def _post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            f"{self.base_url}{path}",
            data=json.dumps(payload).encode(),
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.api_key}",
            },
        )
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())


class OpenAiRuntime(_RestRuntime):
    def __init__(self, api_key: str, model: str = "text-embedding-3-small",
                 base_url: str = "https://api.openai.com/v1", **kw):
        super().__init__(api_key, base_url, **kw)
        self.model = model

    def process(self, texts: list[str]) -> np.ndarray:
        outs = []
        for i in range(0, len(texts), self.batch_size):
            resp = self._post("/embeddings", {
                "model": self.model, "input": texts[i : i + self.batch_size],
            })
            outs.extend(item["embedding"] for item in resp["data"])
        return np.asarray(outs, np.float32)

    def completion(self, prompt: str, model: str = "gpt-4o-mini",
                   system: str | None = None) -> str:
        """llm_completion analog (embeddings.rs llm fns)."""
        messages = ([{"role": "system", "content": system}] if system else []) + [
            {"role": "user", "content": prompt}
        ]
        resp = self._post("/chat/completions", {"model": model, "messages": messages})
        return resp["choices"][0]["message"]["content"]


class CohereRuntime(_RestRuntime):
    def __init__(self, api_key: str, model: str = "embed-english-v3.0",
                 base_url: str = "https://api.cohere.ai/v1", **kw):
        super().__init__(api_key, base_url, **kw)
        self.model = model

    def process(self, texts: list[str], input_type: str = "search_document") -> np.ndarray:
        outs = []
        for i in range(0, len(texts), self.batch_size):
            resp = self._post("/embed", {
                "model": self.model,
                "texts": texts[i : i + self.batch_size],
                "input_type": input_type,
            })
            outs.extend(resp["embeddings"])
        return np.asarray(outs, np.float32)


def get_runtime(name: str, **kw):
    if name == "hash":
        return HashRuntime(**kw)
    if name == "local":
        return LocalTransformerRuntime(**kw)
    if name == "onnx":
        return OnnxRuntime(**kw)
    if name == "openai":
        return OpenAiRuntime(**kw)
    if name == "cohere":
        return CohereRuntime(**kw)
    raise ValueError(f"unknown runtime {name!r}; available: {_RUNTIMES}")


def image_embedding(model: str, image, **kw) -> np.ndarray:
    """One-shot image embedding (the CLIP-visual path,
    ort_runtime.rs:673 process_image_clip)."""
    rt = LocalVisionRuntime(model_path=model, **kw)
    return rt.process([image])[0]


def text_embedding(model: str, text: str, dim: int | None = None,
                   device=None, **kw) -> np.ndarray:
    """One-shot embedding (SQL fn text_embedding(model, text) parity).

    ``device`` is where a local model runs (default ``cuda``); the hash and
    REST runtimes ignore it."""
    if model.startswith("hash"):
        d = dim or KNOWN_MODELS.get(model, ("hash", 128))[1]
        return HashRuntime(dim=d).process([text])[0]
    rt_name, _ = KNOWN_MODELS.get(model, ("local", 0))
    if rt_name == "local":
        # honor the registered pooling for catalog models — bge needs cls,
        # splade needs relu_log_max; mean-pooling them silently produces
        # wrong embeddings (ort_runtime.rs:31-134 pools per model)
        if "pooling" not in kw and model in ONNX_MODELS:
            kw["pooling"] = ONNX_MODELS[model][1]
        return LocalTransformerRuntime(model_path=model, device=device,
                                       **kw).process([text])[0]
    rt = get_runtime(rt_name, model=model, **kw)
    return rt.process([text])[0]


def llm_completion(prompt: str, model: str = "gpt-4o-mini",
                   system: str | None = None, runtime: str = "openai",
                   **kw) -> str:
    """One-shot LLM completion (SQL fn llm_completion parity,
    lantern_extras/src/embeddings.rs llm fns)."""
    rt = get_runtime(runtime, **kw)
    if not hasattr(rt, "completion"):
        raise ValueError(f"runtime {runtime!r} has no completion support")
    return rt.completion(prompt, model=model, system=system)


def measure_speed(runtime, texts: list[str], repeats: int = 3) -> float:
    """Embeddings/sec (measure_speed.rs analog)."""
    import time

    runtime.process(texts[:1])  # warm-up
    t0 = time.perf_counter()
    for _ in range(repeats):
        runtime.process(texts)
    dt = (time.perf_counter() - t0) / repeats
    return len(texts) / dt if dt > 0 else math.inf
