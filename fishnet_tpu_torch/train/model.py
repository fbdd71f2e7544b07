"""Float NNUE model for training, with exact quantization export: the port
of ``fishnet_tpu/train/model.py``.

The float forward is the de-quantized mirror of the integer pipeline in
nnue/spec.py and nnue/torch_eval.py: every scale factor is chosen so
that ``quantize()`` of trained float params yields an ``NnueWeights``
whose integer eval tracks the float eval to within a few centipawns.

Scale conventions (nnue-pytorch-style), as in the JAX package:

* activation unit 1.0  <-> quantized 127
* hidden weight  1.0   <-> quantized 64
* network output 1.0   <-> 600 centipawns (``NNUE2SCORE``)
* the skip neuron is a raw l1 output; with hidden scales (127, 64) its
  integer contribution ``(skip + skip*23/127)/16`` is 600 * skip_f;
* PSQT entry 1.0 <-> 9600, so ``(psqt_stm - psqt_opp)/2/16`` is
  600 * (p_stm - p_opp)/2, the float model's ``material`` term.

Parameters keep the JAX package's names and layouts (``ft_w`` [F, L1],
``l1_w`` [buckets, L2+1, L1], ...), held by an :class:`NnueNet` module
as float32 tensors. ``params_from_jax`` / ``params_to_jax`` carry them
to and from the JAX package's dict of numpy arrays; ``init_params``
draws them from a numpy seed (``jax.random`` draws cannot be
reproduced without jax, so cross-package comparisons carry one dict).

The forward keeps the JAX arithmetic's order: masked gather, bias plus
sum, clip, pairwise product x 127/128, every bucket's einsum then the
bucket's row, skip, material. The masked gather-and-sum is one
``embedding_bag(mode="sum")`` with the mask as per-sample weights, so
the [B, 2, 32, L1] float32 gathered rows are never materialised (nor
their gradient in the backward pass); it sums a row's
products in its own order, so a float32 result may differ from XLA's in
its last bits. The JAX package computes this gather with ``jnp.take``
outside any Pallas kernel, so the port uses PyTorch's.

``quantize`` rounds in numpy float64, exactly as the JAX package does:
the same float arrays give the same ``NnueWeights`` bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fishnet_tpu_torch.nnue import spec
from fishnet_tpu_torch.nnue.weights import NnueWeights

__all__ = [
    "HIDDEN_WEIGHT_CLIP", "NNUE2SCORE", "OUT_WEIGHT_CLIP", "NetConfig",
    "NnueNet", "clip_params", "feature_mask", "forward", "head",
    "init_params", "pair_product", "params_from_jax", "params_to_jax",
    "quantize",
]

NNUE2SCORE = 600.0
# Integer ranges the quantized net must fit in (see quantize()).
HIDDEN_WEIGHT_CLIP = 127.0 / 64.0
OUT_WEIGHT_CLIP = 127.0 * 127.0 / (NNUE2SCORE * spec.FV_SCALE)

#: Parameter names, in the JAX package's order.
PARAM_NAMES = ("ft_w", "ft_b", "ft_psqt", "l1_w", "l1_b", "l2_w", "l2_b",
               "out_w", "out_b")


@dataclass(frozen=True)
class NetConfig:
    num_features: int = spec.NUM_FEATURES
    max_active: int = spec.MAX_ACTIVE_FEATURES
    l1: int = spec.L1
    l2: int = spec.L2
    l3: int = spec.L3
    num_buckets: int = spec.NUM_PSQT_BUCKETS

    @property
    def l1_half(self) -> int:
        return self.l1 // 2

    def is_full_spec(self) -> bool:
        return (
            self.num_features == spec.NUM_FEATURES
            and self.l1 == spec.L1
            and self.l2 == spec.L2
            and self.l3 == spec.L3
            and self.num_buckets == spec.NUM_PSQT_BUCKETS
        )

    def shapes(self) -> Dict[str, tuple]:
        b = self.num_buckets
        return {
            "ft_w": (self.num_features, self.l1),
            "ft_b": (self.l1,),
            "ft_psqt": (self.num_features, b),
            "l1_w": (b, self.l2 + 1, self.l1),
            "l1_b": (b, self.l2 + 1),
            "l2_w": (b, self.l3, 2 * self.l2),
            "l2_b": (b, self.l3),
            "out_w": (b, 1, self.l3),
            "out_b": (b, 1),
        }


def init_params(seed: int = 0, cfg: NetConfig = NetConfig()) -> Dict[str, np.ndarray]:
    """He-style init scaled for the clipped [0, 1] activation regime, the
    JAX package's shapes and bounds, drawn from ``numpy.random``
    (float32 numpy arrays in the JAX layout)."""
    rng = np.random.default_rng(seed)
    shapes = cfg.shapes()

    def unif(name, bound):
        u = rng.random(shapes[name], dtype=np.float32) * np.float32(2.0)
        return ((u - np.float32(1.0)) * np.float32(bound)).astype(np.float32)

    return {
        # Sparse input: ~32 active features -> keep rows small so the
        # accumulator starts inside the clip window.
        "ft_w": unif("ft_w", 0.05),
        "ft_b": np.full(shapes["ft_b"], 0.5, np.float32),
        "ft_psqt": np.zeros(shapes["ft_psqt"], np.float32),
        "l1_w": unif("l1_w", np.sqrt(1.0 / cfg.l1)),
        "l1_b": np.zeros(shapes["l1_b"], np.float32),
        "l2_w": unif("l2_w", np.sqrt(1.0 / (2 * cfg.l2))),
        "l2_b": np.zeros(shapes["l2_b"], np.float32),
        "out_w": unif("out_w", np.sqrt(1.0 / cfg.l3)),
        "out_b": np.zeros(shapes["out_b"], np.float32),
    }


class NnueNet(nn.Module):
    """The float parameters as a module (float32, the JAX layout).
    Indexing by name gives a parameter, so the module is the ``params``
    mapping :func:`forward`, :func:`clip_params` and :func:`quantize`
    take."""

    def __init__(self, cfg: NetConfig = NetConfig()) -> None:
        super().__init__()
        self.cfg = cfg
        for name, shape in cfg.shapes().items():
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


def params_from_jax(params: Mapping[str, np.ndarray], cfg: NetConfig = NetConfig(),
                    device: Union[str, torch.device, None] = None) -> NnueNet:
    """The weight carry: a JAX-layout dict of float32 arrays onto a new
    :class:`NnueNet` (on ``device``, the CPU unless given)."""
    net = NnueNet(cfg)
    with torch.no_grad():
        for name, shape in cfg.shapes().items():
            arr = np.array(params[name], np.float32)  # a writable copy
            if arr.shape != shape:
                raise ValueError(f"{name}: shape {arr.shape}, want {shape} for {cfg}")
            net[name].copy_(torch.from_numpy(arr))
    return net.to(device) if device is not None else net


def params_to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The reverse carry: float32 numpy copies in the JAX layout."""
    return {name: params[name].detach().cpu().numpy().copy()
            for name in PARAM_NAMES}


def _bag_sum(table: torch.Tensor, safe: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum over the last axis of ``table[safe] * mask`` without the
    gathered rows: ``safe`` [B, 2, A] -> [B, 2, table columns]."""
    b, p, a = safe.shape
    out = F.embedding_bag(safe.reshape(b * p, a), table, mode="sum",
                          per_sample_weights=mask.reshape(b * p, a))
    return out.reshape(b, p, table.shape[1])


def _bucket_rows(all_rows: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(all_rows, buckets[:, None, None], 1)[:, 0]``:
    each entry's bucket row of [B, buckets, O]."""
    idx = buckets.to(torch.int64).view(-1, 1, 1).expand(-1, 1, all_rows.shape[2])
    return torch.gather(all_rows, 1, idx)[:, 0]


def _einsum_bko(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bi,koi->bko", x, w)``, every bucket at once."""
    k, o, i = w.shape
    return (x @ w.reshape(k * o, i).T).reshape(-1, k, o)


def forward(params: Mapping[str, torch.Tensor], indices: torch.Tensor,
            buckets: torch.Tensor, cfg: NetConfig = NetConfig()) -> torch.Tensor:
    """Float forward. ``indices`` int [B, 2, A] (stm perspective first),
    padded with any value >= cfg.num_features; ``buckets`` int [B].
    Returns float32 [B] in network-output units (multiply by NNUE2SCORE
    for centipawns)."""
    safe, mask = feature_mask(indices, cfg)

    acc = params["ft_b"] + _bag_sum(params["ft_w"], safe, mask)  # [B, 2, L1]
    psqt = _bag_sum(params["ft_psqt"], safe, mask)  # [B, 2, buckets]
    x = pair_product(acc)  # [B, L1], stm half first

    y_all = _einsum_bko(x, params["l1_w"]) + params["l1_b"][None]
    return head(params, y_all, psqt, buckets, cfg)


def feature_mask(indices: torch.Tensor, cfg: NetConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(safe indices, float mask) of padded feature indices [B, 2, A]."""
    indices = indices.to(torch.int64)
    mask = (indices < cfg.num_features).to(torch.float32)
    safe = torch.clamp(indices, max=cfg.num_features - 1)
    return safe, mask


def pair_product(acc: torch.Tensor) -> torch.Tensor:
    """The FT accumulators [B, 2, 2n] clipped and multiplied pairwise
    (column j by column n + j) x 127/128: [B, 2n], stm pairs first."""
    half = acc.shape[-1] // 2
    c = torch.clamp(acc, 0.0, 1.0)
    pair = c[..., :half] * c[..., half:] * (127.0 / 128.0)
    return pair.reshape(pair.shape[0], 2 * half)


def head(params: Mapping[str, torch.Tensor], y_all: torch.Tensor,
         psqt: torch.Tensor, buckets: torch.Tensor,
         cfg: NetConfig) -> torch.Tensor:
    """Everything after the L1 product: ``y_all`` [B, buckets, L2+1]
    (bias included) and the PSQT sums [B, 2, buckets] -> [B]."""
    y = _bucket_rows(y_all, buckets)  # [B, L2+1]

    skip = y[:, cfg.l2]
    h = y[:, : cfg.l2]
    sq = torch.clamp(h * h * (127.0 / 128.0), max=1.0)
    ca = torch.clamp(h, 0.0, 1.0)
    act = torch.cat([sq, ca], dim=1)  # [B, 2*L2]

    z_all = _einsum_bko(act, params["l2_w"]) + params["l2_b"][None]
    z = torch.clamp(_bucket_rows(z_all, buckets), 0.0, 1.0)

    v_all = _einsum_bko(z, params["out_w"]) + params["out_b"][None]
    v = _bucket_rows(v_all, buckets)[:, 0]

    sel = buckets.to(torch.int64).view(-1, 1, 1).expand(-1, 2, 1)
    p_sel = torch.gather(psqt, 2, sel)[..., 0]  # [B, 2]
    material = (p_sel[:, 0] - p_sel[:, 1]) * 0.5
    return v + skip + material


def clip_params(params: Mapping[str, torch.Tensor]) -> None:
    """Project weights back into quantization-representable ranges, in
    place (quantization-aware training, the standard NNUE recipe; the
    JAX package returns a clipped copy)."""
    with torch.no_grad():
        params["l1_w"].clamp_(-HIDDEN_WEIGHT_CLIP, HIDDEN_WEIGHT_CLIP)
        params["l2_w"].clamp_(-HIDDEN_WEIGHT_CLIP, HIDDEN_WEIGHT_CLIP)
        params["out_w"].clamp_(-OUT_WEIGHT_CLIP, OUT_WEIGHT_CLIP)


def quantize(params: Mapping, cfg: NetConfig = NetConfig()) -> NnueWeights:
    """Export float params (tensors or numpy arrays) to the integer
    NnueWeights the serving path consumes. Only defined for full-spec
    shapes."""
    if not cfg.is_full_spec():
        raise ValueError("quantize() requires full-spec NetConfig")

    def rnd(name, scale, dtype, lo, hi):
        x = params[name]
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        arr = np.asarray(x, np.float64) * scale
        return np.clip(np.round(arr), lo, hi).astype(dtype)

    hid = 1 << spec.WEIGHT_SCALE_BITS  # 64
    out_w_scale = NNUE2SCORE * spec.FV_SCALE / 127.0
    out_b_scale = NNUE2SCORE * spec.FV_SCALE
    psqt_scale = NNUE2SCORE * spec.FV_SCALE  # 9600

    weights = NnueWeights(
        ft_weight=rnd("ft_w", 127.0, np.int16, -32768, 32767),
        ft_bias=rnd("ft_b", 127.0, np.int16, -32768, 32767),
        ft_psqt=rnd("ft_psqt", psqt_scale, np.int32, -(2**31) + 1, 2**31 - 1),
        l1_weight=rnd("l1_w", hid, np.int8, -127, 127),
        l1_bias=rnd("l1_b", hid * 127.0, np.int32, -(2**31), 2**31 - 1),
        l2_weight=rnd("l2_w", hid, np.int8, -127, 127),
        l2_bias=rnd("l2_b", hid * 127.0, np.int32, -(2**31), 2**31 - 1),
        out_weight=rnd("out_w", out_w_scale, np.int8, -127, 127),
        out_bias=rnd("out_b", out_b_scale, np.int32, -(2**31), 2**31 - 1),
    )
    weights.validate()
    return weights
