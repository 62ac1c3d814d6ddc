"""ResNet, the counterpart of ``kubetorch_tpu/models/resnet.py`` (flax):
ResNet-18/50 with BatchNorm, the bench's config 2 (ResNet-50 data
parallel on a mesh).

The param tree keeps flax's module names (``conv_init``, ``bn_init``,
``ResNetBlock_0`` or ``BottleneckBlock_0`` with ``Conv_i``,
``BatchNorm_i``, ``conv_proj``, ``norm_proj``, then ``Dense_0``), so a
flax ``variables`` tree carries across leaf for leaf
(``models.convert.resnet_from_flax``). Two leaves differ in layout: a
conv ``kernel`` is PyTorch's (O, I, kh, kw), not flax's HWIO, and the
BatchNorm statistics live in a tree of their own, ``batch_stats``, as
flax's mutable collection.

Images are NHWC at the API, as in JAX; inside, activations are NCHW
tensors in ``channels_last`` memory (NHWC bytes, the layout cuDNN's
tensor-core convolutions read). The dtypes are flax's: convolutions in
``cfg.dtype`` (input and kernel cast, params stored fp32), BatchNorm in
fp32, the head ``Dense`` in fp32. The convolutions are
``torch.nn.functional.conv2d`` (cuDNN on the card): the JAX model runs
no Pallas kernel either.

Three places where a straight translation would be a different model:

- ``padding="SAME"`` is XLA's: out = ceil(in / stride), the padding's
  odd unit at the end (:func:`same_pads`). A 3×3 stride-2 conv or the
  stem's 3×3 stride-2 max pool over an even input pads (0, 1), not
  (1, 1); the pool pads with -inf.
- BatchNorm's statistics are flax's (``_compute_stats``): the fast
  variance E[x²] - E[x]², clipped at 0, biased, in fp32; running
  averages ``0.9·ra + (1 - 0.9)·batch``. ``F.batch_norm`` would update
  ``running_var`` with the unbiased variance.
- On a mesh (images a DTensor sharded on the batch over the data-like
  axes) the moments are the whole batch's, as GSPMD computes them: each
  rank's sums are all-reduced over the batch axes
  (:func:`batch_moments`). A per-rank BatchNorm would be another model.

``resnet_loss(params, batch_stats, images, labels, cfg, train=True)``
returns ``(loss, new_batch_stats)``, the JAX function's pair: in train
mode the batch's statistics normalize and update the running averages;
with ``train=False`` the running averages normalize and the new stats
are ``{}``, as in JAX. The training step is the caller's, built from
``resnet_loss`` and ``train.optim.sgd`` as in ``examples/resnet_dp.py``.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .common import generator, resolve_device

MOMENTUM = 0.9
EPSILON = 1e-5
# flax's truncated-normal variance_scaling: the stddev of a standard normal
# truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial dim: the output has
    ceil(size / stride) positions; the total padding is split with the
    odd unit at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, kernel: torch.Tensor, stride: int,
         padding: Union[str, Sequence[Tuple[int, int]]],
         dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(use_bias=False, dtype=dtype)``: x (N, C, H, W) and
    the kernel (O, I, kh, kw) cast to ``dtype``, the output in ``dtype``.
    ``padding`` is ``"SAME"`` or flax's explicit ((lo, hi), (lo, hi))."""
    kh, kw = kernel.shape[2:]
    if padding == "SAME":
        padding = (same_pads(x.shape[2], kh, stride),
                   same_pads(x.shape[3], kw, stride))
    (ph0, ph1), (pw0, pw1) = padding
    x = x.to(dtype)
    w = kernel.to(dtype, memory_format=torch.channels_last)
    if ph0 == ph1 and pw0 == pw1:
        return F.conv2d(x, w, stride=stride, padding=(ph0, pw0))
    return F.conv2d(F.pad(x, (pw0, pw1, ph0, ph1)), w, stride=stride)


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """``nn.max_pool(x, (w, w), (s, s), padding="SAME")``: padded with
    -inf by XLA's SAME rule, so a pad never wins the max."""
    ph, pw = (same_pads(x.shape[d], window, stride) for d in (2, 3))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def batch_moments(x: torch.Tensor, count: int,
                  groups: Sequence[Any] = ()) -> Tuple[torch.Tensor, torch.Tensor]:
    """flax's fast batch statistics over (N, H, W) of x (N, C, H, W), in
    fp32: the sums of x and x² (all-reduced over ``groups``, the process
    groups of the mesh dims that shard the batch, in one reduction) over
    ``count`` elements, mean = E[x], var = max(E[x²] - E[x]², 0). The
    all-reduce is differentiable: its backward sums each rank's
    gradient of the moments."""
    xf = x.float()
    sums = torch.stack([xf.sum(dim=(0, 2, 3)), xf.square().sum(dim=(0, 2, 3))])
    if groups:
        from torch.distributed.nn.functional import all_reduce
        for g in groups:
            sums = all_reduce(sums, group=g)
    mean, mean2 = sums[0] / count, sums[1] / count
    return mean, torch.clamp(mean2 - mean.square(), min=0.0)


def running_average(ra: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
    """flax's update of a running statistic: ``m·ra + (1 - m)·batch``."""
    return MOMENTUM * ra + (1 - MOMENTUM) * batch


@dataclass
class _Norm:
    """What every BatchNorm of one forward shares: the mode, the
    element count of the whole batch per channel's spatial map, the
    mesh groups of the moments, and the new statistics it collects."""

    train: bool
    batch: int
    groups: Sequence[Any]
    new_stats: Dict[str, Any]

    def __call__(self, x, p, stats, path: Tuple[str, ...]) -> torch.Tensor:
        """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5,
        dtype=float32)`` over channels: x (N, C, H, W) → fp32."""
        if self.train:
            n = self.batch * x.shape[2] * x.shape[3]
            mean, var = batch_moments(x, n, self.groups)
            node = self.new_stats
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = {
                "mean": running_average(stats["mean"], mean.detach()),
                "var": running_average(stats["var"], var.detach())}
        else:
            mean, var = stats["mean"], stats["var"]
        mul = torch.rsqrt(var + EPSILON) * p["scale"]
        y = (x.float() - mean[:, None, None]) * mul[:, None, None]
        return y + p["bias"][:, None, None]


def ResNetBlock(x, p, stats, filters: int, strides: int, dtype, norm: _Norm,
                path: Tuple[str, ...]) -> torch.Tensor:
    """flax's ``ResNetBlock``: two 3×3 convs (the first at ``strides``),
    a 1×1 projection of the residual where the shapes differ."""
    y = conv(x, p["Conv_0"]["kernel"], strides, "SAME", dtype)
    y = F.relu(norm(y, p["BatchNorm_0"], stats["BatchNorm_0"], path + ("BatchNorm_0",)))
    y = conv(y, p["Conv_1"]["kernel"], 1, "SAME", dtype)
    y = norm(y, p["BatchNorm_1"], stats["BatchNorm_1"], path + ("BatchNorm_1",))
    return F.relu(_residual(x, p, stats, strides, dtype, norm, path) + y)


def BottleneckBlock(x, p, stats, filters: int, strides: int, dtype,
                    norm: _Norm, path: Tuple[str, ...]) -> torch.Tensor:
    """flax's ``BottleneckBlock``: 1×1, 3×3 (at ``strides``), 1×1 to
    4·filters, a 1×1 projection of the residual where the shapes differ."""
    y = conv(x, p["Conv_0"]["kernel"], 1, "SAME", dtype)
    y = F.relu(norm(y, p["BatchNorm_0"], stats["BatchNorm_0"], path + ("BatchNorm_0",)))
    y = conv(y, p["Conv_1"]["kernel"], strides, "SAME", dtype)
    y = F.relu(norm(y, p["BatchNorm_1"], stats["BatchNorm_1"], path + ("BatchNorm_1",)))
    y = conv(y, p["Conv_2"]["kernel"], 1, "SAME", dtype)
    y = norm(y, p["BatchNorm_2"], stats["BatchNorm_2"], path + ("BatchNorm_2",))
    return F.relu(_residual(x, p, stats, strides, dtype, norm, path) + y)


def _residual(x, p, stats, strides, dtype, norm, path):
    if "conv_proj" not in p:
        return x
    r = conv(x, p["conv_proj"]["kernel"], strides, "SAME", dtype)
    return norm(r, p["norm_proj"], stats["norm_proj"], path + ("norm_proj",))


# the names under which flax numbers each block class
_BLOCK_NAME = {ResNetBlock: "ResNetBlock", BottleneckBlock: "BottleneckBlock"}
# per block class: (conv kernel sizes, channel multiplier of the output)
_BLOCK_SHAPE = {ResNetBlock: ((3, 3), 1), BottleneckBlock: ((1, 3, 1), 4)}


@dataclass(frozen=True)
class ResNet:
    """flax's ``ResNet`` hyperparameters; ``ResNet18``/``ResNet50`` fill in
    the stages and the block."""

    stage_sizes: Tuple[int, ...]
    block_cls: Callable
    num_classes: int = 1000
    num_filters: int = 64
    dtype: Any = torch.bfloat16

    def blocks(self):
        """(flax name, filters, strides, input channels) of every block."""
        name = _BLOCK_NAME[self.block_cls]
        mult = _BLOCK_SHAPE[self.block_cls][1]
        c_in, k = self.num_filters, 0
        for i, size in enumerate(self.stage_sizes):
            for j in range(size):
                filters = self.num_filters * 2 ** i
                yield (f"{name}_{k}", filters, 2 if i > 0 and j == 0 else 1,
                       c_in)
                c_in, k = filters * mult, k + 1

    @property
    def features(self) -> int:
        """Channels into the head."""
        return (self.num_filters * 2 ** (len(self.stage_sizes) - 1)
                * _BLOCK_SHAPE[self.block_cls][1])


ResNet18 = functools.partial(ResNet, stage_sizes=(2, 2, 2, 2),
                             block_cls=ResNetBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3),
                             block_cls=BottleneckBlock)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _lecun(gen: torch.Generator, shape, fan_in: int,
           device: torch.device) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated to two standard
    deviations, scaled to variance 1 / fan_in, fp32."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).to(device)


def resnet_init(gen: Union[int, torch.Generator], cfg: ResNet,
                device=None) -> Tuple[Dict, Dict]:
    """Random ``(params, batch_stats)``, fp32, flax's initializers: convs
    and the head lecun-normal, biases zero, BatchNorm scale one except
    each block's last norm (zero), running means zero and variances one.
    ``gen`` is a ``torch.Generator`` or an int seed."""
    device = resolve_device(device)
    gen = generator(gen, device)

    def kernel(o, i, k):
        return {"kernel": _lecun(gen, (o, i, k, k), i * k * k, device)}

    def norm(c, scale=1.0):
        return ({"scale": torch.full((c,), scale, device=device),
                 "bias": torch.zeros(c, device=device)},
                {"mean": torch.zeros(c, device=device),
                 "var": torch.ones(c, device=device)})

    nf = cfg.num_filters
    params = {"conv_init": kernel(nf, 3, 7)}
    stats = {}
    params["bn_init"], stats["bn_init"] = norm(nf)
    sizes, mult = _BLOCK_SHAPE[cfg.block_cls]
    for name, filters, strides, c_in in cfg.blocks():
        p, s = {}, {}
        c = c_in
        for i, k in enumerate(sizes):
            out = filters * mult if i == len(sizes) - 1 else filters
            p[f"Conv_{i}"] = kernel(out, c, k)
            last = i == len(sizes) - 1
            p[f"BatchNorm_{i}"], s[f"BatchNorm_{i}"] = norm(out, 0.0 if last else 1.0)
            c = out
        if c_in != c or strides != 1:
            p["conv_proj"] = kernel(c, c_in, 1)
            p["norm_proj"], s["norm_proj"] = norm(c)
        params[name], stats[name] = p, s
    params["Dense_0"] = {
        "kernel": _lecun(gen, (cfg.features, cfg.num_classes), cfg.features,
                         device),
        "bias": torch.zeros(cfg.num_classes, device=device)}
    return params, stats


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------


def resnet_forward(params: Dict, batch_stats: Dict, images: torch.Tensor,
                   cfg: ResNet, train: bool = True, *,
                   batch: Optional[int] = None,
                   groups: Sequence[Any] = ()) -> Tuple[torch.Tensor, Dict]:
    """images (N, H, W, 3) NHWC → (logits (N, num_classes) fp32, new
    batch_stats; ``{}`` unless ``train``). Plain tensors. ``batch`` and
    ``groups``: on a mesh, the whole batch's size and the process groups
    its moments reduce over (:func:`batch_moments`); this call then holds
    one rank's rows."""
    norm = _Norm(train, images.shape[0] if batch is None else batch, groups,
                 {})
    x = images.permute(0, 3, 1, 2)          # NCHW view of NHWC bytes
    x = conv(x, params["conv_init"]["kernel"], 2, ((3, 3), (3, 3)), cfg.dtype)
    x = F.relu(norm(x, params["bn_init"], batch_stats["bn_init"], ("bn_init",)))
    x = max_pool_same(x, 3, 2)
    for name, filters, strides, _ in cfg.blocks():
        x = cfg.block_cls(x, params[name], batch_stats[name], filters,
                          strides, cfg.dtype, norm, (name,))
    x = x.mean(dim=(2, 3))
    dense = params["Dense_0"]
    return x @ dense["kernel"] + dense["bias"], norm.new_stats


def _xent_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None]).sum()


def resnet_loss(params: Dict, batch_stats: Dict, images: torch.Tensor,
                labels: torch.Tensor, cfg: ResNet,
                train: bool = True) -> Tuple[torch.Tensor, Dict]:
    """Mean cross-entropy of the logits and the new ``batch_stats``
    (``{}`` when ``train=False``), the JAX function's pair.

    On a mesh ``images`` (and ``labels``) are DTensors sharded on the
    batch (``parallel.sharding.batch_sharding``) and the params and stats
    replicated DTensors: each rank runs the model on its rows with the
    BatchNorm moments all-reduced over the batch axes, the loss comes
    back as a pending sum over them (``Partial``; redistribute it to
    ``Replicate`` before the backward, as ``make_train_step`` does) and
    each param's gradient comes back as a pending sum, reduced where the
    caller redistributes it to the param's placements. The new stats are
    replicated."""
    from ..parallel.mesh import is_dtensor

    if is_dtensor(images):
        return _loss_on_mesh(params, batch_stats, images, labels, cfg, train)
    logits, new = resnet_forward(params, batch_stats, images, cfg, train)
    return _xent_sum(logits, labels) / images.shape[0], new


def _loss_on_mesh(params, batch_stats, images, labels, cfg, train):
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from ..parallel.mesh import is_dtensor
    from ..parallel.sharding import local_slice
    from ..train.optim import tree_map

    mesh = images.device_mesh
    dims = [i for i, p in enumerate(images.placements) if p.is_shard(0)]
    if any(p.is_shard() and not p.is_shard(0) for p in images.placements):
        raise ValueError("ResNet on a mesh shards the batch only; images "
                         f"are laid out as {list(images.placements)}")
    pending = [Partial() if i in dims else Replicate() for i in range(mesh.ndim)]
    whole = [Replicate()] * mesh.ndim

    def local(t):
        # a replicated param as this rank's tensor; its gradient returns
        # as a pending sum over the batch dims
        if not is_dtensor(t):
            return t
        t = t.redistribute(mesh, whole)
        return t.to_local(grad_placements=pending)

    if is_dtensor(labels):
        labels = labels.redistribute(mesh, images.placements).to_local()
    else:
        labels = local_slice(labels, mesh, images.placements)
    logits, new = resnet_forward(
        tree_map(local, params),
        tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t, batch_stats),
        images.to_local(), cfg, train, batch=images.shape[0],
        groups=[mesh.get_group(i) for i in dims])
    loss = DTensor.from_local(_xent_sum(logits, labels) / images.shape[0],
                              mesh, pending, run_check=False)
    new = tree_map(lambda t: DTensor.from_local(t, mesh, whole,
                                                run_check=False), new)
    return loss, new


__all__: List[str] = ["ResNet", "ResNet18", "ResNet50", "ResNetBlock",
                      "BottleneckBlock", "resnet_init", "resnet_forward",
                      "resnet_loss", "same_pads", "batch_moments"]
