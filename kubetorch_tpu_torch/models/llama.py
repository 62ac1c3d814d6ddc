"""Llama-3-family decoder in PyTorch, the counterpart of
``kubetorch_tpu/models/llama.py``: forward, losses and their gradient.

Same parameter layout as the JAX model: every layer's weights are one
tensor with a leading ``(L, ...)`` dim, so a JAX param tree loads as it is
(``models.convert.params_from_numpy``). bf16 on the matmul path, fp32 for
norms, RoPE and softmax accumulation, fp32 logits.

Attention dispatches to the hand-written flash kernels (``ops.attention``:
forward, and dQ / dK-dV in the backward) on CUDA and to the plain version
on the CPU. Under grad mode each layer is rematerialized per
``cfg.remat_policy`` (``models/common.py``), as the JAX scan body is.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .common import checkpointed
from .common import config_from_dict as _config_from_dict
from .common import nothing_saveable, resolve_device, resolve_remat_policy


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    remat: bool = True
    # Named remat policy for each layer under grad mode: "none" | "dots" |
    # "nothing_saveable" | a selective-checkpoint policy callable
    # (models/common.py). None keeps the JAX default: remat=True → "dots".
    remat_policy: Any = None
    # auto | xla | flash. auto: the flash kernel on CUDA, the plain
    # attention on the CPU. "xla" keeps the JAX package's name for the
    # plain einsum attention so configs carry over unchanged.
    attn_impl: str = "auto"
    # Llama-3.1 NTK frequency scaling: (factor, low_freq_factor,
    # high_freq_factor, original_max_position_embeddings). None = plain
    # rope_theta.
    rope_scaling: Optional[tuple] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def llama3_1b(cls, **kw) -> "LlamaConfig":
        d = dict(dim=2048, n_layers=16, n_heads=32, n_kv_heads=8, ffn_dim=8192)
        d.update(kw)
        return cls(**d)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        d = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                 ffn_dim=128, max_seq_len=128)
        d.update(kw)
        return cls(**d)

    def param_count(self) -> int:
        d, f, L = self.dim, self.ffn_dim, self.n_layers
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        ffn = 3 * d * f
        return self.vocab_size * d * 2 + L * (attn + ffn + 2 * d) + d


def llama_init(cfg: LlamaConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random params in the JAX model's stacked layout, drawn from a
    ``torch.Generator`` seeded with ``seed`` on the target device. Each leaf
    is drawn in fp32 and cast, one leaf at a time (peak extra memory is one
    fp32 leaf)."""
    device = resolve_device(device)
    d, L = cfg.dim, cfg.n_layers
    hd, nh, nkv, f = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def init(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return w.mul_(1.0 / math.sqrt(fan_in)).to(cfg.dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=torch.float32)

    return {
        "embed": init((cfg.vocab_size, d), d),
        "layers": {
            "attn_norm": ones(L, d),
            "wq": init((L, d, nh * hd), d),
            "wk": init((L, d, nkv * hd), d),
            "wv": init((L, d, nkv * hd), d),
            "wo": init((L, nh * hd, d), nh * hd),
            "ffn_norm": ones(L, d),
            "w_gate": init((L, d, f), d),
            "w_up": init((L, d, f), d),
            "w_down": init((L, f, d), f),
        },
        "final_norm": ones(d),
        "lm_head": init((d, cfg.vocab_size), d),
    }


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale * weight).to(x.dtype)


def rope_freqs(cfg: LlamaConfig, seq_len: int, device=None) -> torch.Tensor:
    """(S, Hd/2) complex64 rotation table."""
    inv = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, cfg.head_dim, 2, dtype=torch.float32, device=device)
        / cfg.head_dim))
    # getattr: MoeConfig (models/moe.py) has no rope_scaling field
    rs = getattr(cfg, "rope_scaling", None)
    if rs is not None:
        # Llama-3.1 long-context scaling: wavelengths longer than the
        # original training context are slowed by ``factor``, short ones
        # kept, and the band between interpolates
        factor, low_fac, high_fac, orig_ctx = rs
        wavelen = 2.0 * math.pi / inv
        low_wl = orig_ctx / low_fac
        high_wl = orig_ctx / high_fac
        smooth = torch.clamp((orig_ctx / wavelen - low_fac)
                             / (high_fac - low_fac), 0.0, 1.0)
        inv = torch.where(
            wavelen < high_wl, inv,
            torch.where(wavelen > low_wl, inv / factor,
                        (1.0 - smooth) * inv / factor + smooth * inv))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.complex(torch.cos(freqs), torch.sin(freqs))


def _rotate(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs (x[2i], x[2i+1]) of the last dim by the
    complex ``freqs`` (broadcast against x's pair axis), in fp32. This is
    the JAX model's layout, not HF's ``rotate_half``."""
    xf = x.float().reshape(*x.shape[:-1], -1, 2)
    rotated = torch.view_as_complex(xf.contiguous()) * freqs
    return torch.view_as_real(rotated).reshape(x.shape).to(x.dtype)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x: (B, S, N, Hd); freqs (S, Hd/2). Returns x.dtype."""
    return _rotate(x, freqs[None, :, None, :])


def _xla_attention(q, k, v, scale: float, causal: bool = True) -> torch.Tensor:
    """Plain attention, fp32 softmax, P rounded to v's type before the PV
    product (as the JAX reference does). q:(B,S,N,Hd) k,v:(B,S,NKV,Hd)."""
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    group = nh // nkv
    qg = q.reshape(b, s, nkv, group, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * scale
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(b, s, nh, hd)


def attention(q, k, v, cfg: LlamaConfig) -> torch.Tensor:
    """Causal self-attention dispatch: ``auto`` takes the flash kernel on
    CUDA and the plain attention on the CPU; ``flash`` forces the flash
    wrapper (whose CPU path is its plain version); ``xla`` the plain one."""
    scale = 1.0 / (cfg.head_dim ** 0.5)
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "flash" if q.is_cuda else "xla"
    if impl == "flash":
        from ..ops.attention import flash_attention
        return flash_attention(q, k, v, causal=True, scale=scale)
    if impl in ("ring", "ulysses", "ring_local", "ulysses_local"):
        raise NotImplementedError(
            f"attn_impl={impl!r} (context parallelism) is not ported")
    if impl != "xla":
        raise ValueError(f"unknown attn_impl {impl!r}; expected auto|xla|flash")
    return _xla_attention(q, k, v, scale)


def _layer(cfg: LlamaConfig, x: torch.Tensor, lw: Dict[str, torch.Tensor],
           freqs: torch.Tensor) -> torch.Tensor:
    """One decoder layer over (B, S, D)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = rmsnorm(x, lw["attn_norm"], cfg.norm_eps)
    q = (h @ lw["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (h @ lw["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ lw["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    q, k = apply_rope(q, freqs), apply_rope(k, freqs)
    x = x + attention(q, k, v, cfg).reshape(b, s, -1) @ lw["wo"]
    h = rmsnorm(x, lw["ffn_norm"], cfg.norm_eps)
    ffn = (torch.nn.functional.silu(h @ lw["w_gate"]) * (h @ lw["w_up"])) @ lw["w_down"]
    return x + ffn


def _layer_slice(w: Any, i: int) -> Any:
    if isinstance(w, dict):   # a quantized leaf: every array in it is stacked
        return {k: _layer_slice(v, i) for k, v in w.items()}
    return w[i]


def layer_weights(params: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s weights: views into the stacked ``(L, ...)`` leaves. A
    quantized leaf (``models.quant``, e.g. ``{"__kt_q4__": (L, K/2, N),
    "scale": (L, K/g, N)}``) is sliced key by key and reaches the layer as
    a dict, as a ``lax.scan`` over the JAX param tree gives it."""
    return {name: _layer_slice(w, i) for name, w in params["layers"].items()}


def llama_hidden(params: Dict[str, Any], tokens: torch.Tensor,
                 cfg: LlamaConfig) -> torch.Tensor:
    """tokens (B, S) → final hidden states (B, S, D).

    Under grad mode each layer runs inside a checkpoint with the config's
    remat policy, and each stacked leaf is unbound once before the loop:
    indexing ``w[i]`` per layer would give every layer's backward a
    zero-filled gradient of the whole (L, ...) leaf to add into."""
    x = params["embed"][tokens].to(cfg.dtype)
    freqs = rope_freqs(cfg, tokens.shape[1], device=tokens.device)
    if not torch.is_grad_enabled():
        for i in range(cfg.n_layers):
            x = _layer(cfg, x, layer_weights(params, i), freqs)
        return rmsnorm(x, params["final_norm"], cfg.norm_eps)
    policy = cfg.remat_policy
    if policy is None:
        policy = "dots" if cfg.remat else "none"
    layer = checkpointed(lambda x, lw: _layer(cfg, x, lw, freqs),
                         resolve_remat_policy(policy))
    per_layer = {name: w.unbind(0) for name, w in params["layers"].items()}
    for i in range(cfg.n_layers):
        x = layer(x, {name: ws[i] for name, ws in per_layer.items()})
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def _logits(params: Dict[str, Any], tokens: torch.Tensor,
            cfg: LlamaConfig) -> torch.Tensor:
    x = llama_hidden(params, tokens, cfg)
    return (x @ params["lm_head"].to(cfg.dtype)).float()


@torch.no_grad()
def llama_forward(params: Dict[str, Any], tokens: torch.Tensor,
                  cfg: LlamaConfig) -> torch.Tensor:
    """tokens (B, S) int → logits (B, S, V) fp32."""
    return _logits(params, tokens, cfg)


def llama_loss(params: Dict[str, Any], tokens: torch.Tensor,
               targets: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Next-token cross-entropy, fp32 log-softmax, mean over all positions."""
    logp = F.log_softmax(_logits(params, tokens, cfg), dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return -ll.mean()


def _chunk_loss(h: torch.Tensor, t: torch.Tensor, m: torch.Tensor,
                head: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax((h @ head).float(), dim=-1)       # (B, C, V)
    ll = torch.gather(logp, -1, t[..., None])[..., 0]
    return (ll * m).sum()


def chunked_ce(x: torch.Tensor, targets: torch.Tensor, head: torch.Tensor,
               chunk: int = 256) -> torch.Tensor:
    """Cross-entropy over hidden states without the (B, S, V) logits: the
    LM head and log-softmax run per sequence chunk, each chunk checkpointed
    under grad mode, so the peak is one (B, chunk, V) fp32 block and the
    backward recomputes each chunk's logits. A sequence that does not
    divide the chunk is padded and masked, never cut into smaller chunks."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    targets = targets.long()
    mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    loss_of = _chunk_loss
    if torch.is_grad_enabled():
        loss_of = checkpointed(_chunk_loss, nothing_saveable)
    # one split per tensor: its backward is one concatenation of the
    # chunks' grads, not a full-size zero tensor per chunk
    total = sum(loss_of(h, t, m, head) for h, t, m in
                zip(x.split(chunk, 1), targets.split(chunk, 1), mask.split(chunk, 1)))
    return -total / (b * s)


def llama_loss_chunked(params: Dict[str, Any], tokens: torch.Tensor,
                       targets: torch.Tensor, cfg: LlamaConfig,
                       chunk: int = 256) -> torch.Tensor:
    """Next-token CE without materializing (B, S, V) logits (see
    :func:`chunked_ce`)."""
    x = llama_hidden(params, tokens, cfg)
    return chunked_ce(x, targets, params["lm_head"].to(cfg.dtype), chunk)


def config_from_dict(d: Dict) -> LlamaConfig:
    return _config_from_dict(LlamaConfig, d)
