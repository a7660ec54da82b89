"""MIMONet — computation in superposition (Menet et al., NeurIPS'23), in PyTorch.

The port of ``repro.models.mimonet``: the serving path, and the training
half (``loss_fn`` with train-mode batchnorm, the BN EMA fold,
``accuracy``).  K
inputs are bound with per-channel unitary keys, bundled into one superposed
code, pushed through one shared trunk (one forward pass for K inputs), then
unbound per channel and classified.  Binding and unbinding run on the
circ_conv kernel; the fused symbolic tail (unbind + classify) on the
``unbind_classify`` kernel.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.backend import registry
from repro_torch.data.raven import RavenConfig
from repro_torch.kernels.unbind_classify import ops as uc_ops
from repro_torch.nn import layers, resnet
from repro_torch.vsa import ops as vsa


@dataclasses.dataclass(frozen=True)
class MIMONetConfig:
    raven: RavenConfig = RavenConfig()
    n_channels: int = 2     # K superposed inputs
    blocks: int = 4
    d: int = 128
    cnn_width: int = 8
    trunk_layers: int = 2
    trunk_hidden: int = 1024
    n_classes: int = 5      # classify shape type


def _resnet_cfg(cfg: MIMONetConfig) -> resnet.ResNetConfig:
    return resnet.ResNetConfig(in_channels=1, width=cfg.cnn_width,
                               out_dim=cfg.blocks * cfg.d)


def mimonet_spec(cfg: MIMONetConfig):
    code_dim = cfg.blocks * cfg.d
    trunk = [{
        "up": layers.dense_spec(code_dim, cfg.trunk_hidden, ("embed", "mlp"),
                                bias=True),
        "down": layers.dense_spec(cfg.trunk_hidden, code_dim, ("mlp", "embed"),
                                  bias=True),
    } for _ in range(cfg.trunk_layers)]
    return {
        "encoder": resnet.resnet_spec(_resnet_cfg(cfg)),
        "trunk": trunk,
        "head": layers.dense_spec(code_dim, cfg.n_classes, ("embed", None),
                                  bias=True),
    }


def mimonet_keys(cfg: MIMONetConfig, generator: torch.Generator) -> torch.Tensor:
    """Static unitary binding keys (K, B, d), one per channel (exactly
    invertible); CPU tensor."""
    return vsa.unitary_codebook(generator, cfg.n_channels, cfg.blocks, cfg.d)


# -- pipeline stages (the serving schedule binds these 1:1) -----------------
# encode (nn) -> superpose (vsa) -> trunk (nn) -> unbind (vsa) -> classify
# (simd)


def encode(params, cfg: MIMONetConfig, images: torch.Tensor, train: bool = False,
           bn_stats: dict | None = None) -> torch.Tensor:
    """images: (N, K, H, W, 1) -> per-channel codes (N, K, blocks, d).
    ``train=False`` uses the running BN stats: a request's codes do not
    depend on its group.  ``train=True`` uses batch statistics and records
    them in ``bn_stats`` for ``apply_bn_stats``."""
    n, k, h, w, c = images.shape
    feats = resnet.resnet(params["encoder"], _resnet_cfg(cfg),
                          images.reshape(n * k, h, w, c), train=train,
                          bn_stats=bn_stats)
    return feats.reshape(n, k, cfg.blocks, cfg.d)


def superpose(keys: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Bind each channel with its key and bundle: (N, K, B, d) -> (N, B*d)."""
    n = codes.shape[0]
    bound = vsa.bind(codes, keys[None])
    return bound.sum(dim=1).reshape(n, -1)


def trunk(params, x: torch.Tensor) -> torch.Tensor:
    """One residual-MLP pass over the superposed code.  GELU is the tanh
    approximation, ``jax.nn.gelu``'s default (``F.gelu``'s is exact erf)."""
    for lyr in params["trunk"]:
        hdn = F.gelu(layers.dense(lyr["up"], x), approximate="tanh")
        x = x + layers.dense(lyr["down"], hdn)
    return x


def unbind(keys: torch.Tensor, cfg: MIMONetConfig, x: torch.Tensor) -> torch.Tensor:
    """Per-channel codes from the trunk output: (N, B*d) -> (N, K, B*d)."""
    n, k = x.shape[0], cfg.n_channels
    shape = (n, k, cfg.blocks, cfg.d)
    unbound = vsa.unbind(keys[None].expand(shape),
                         x.reshape(n, 1, cfg.blocks, cfg.d).expand(shape))
    return unbound.reshape(n, k, -1)


def classify(params, unbound: torch.Tensor) -> torch.Tensor:
    """Per-channel head: (N, K, B*d) -> logits (N, K, n_classes)."""
    return layers.dense(params["head"], unbound, torch.float32)


def unbind_classify(params, keys: torch.Tensor, cfg: MIMONetConfig,
                    x: torch.Tensor) -> torch.Tensor:
    """Fused symbolic tail: (N, B*d) -> logits (N, K, n_classes).

    One ``unbind_classify`` kernel call at block dims at or above its
    dispatch floor (128); below it ``classify(unbind(...))``, as the
    reference routes."""
    if registry.dispatch_path("unbind_classify", cfg.d) == "gather":
        return classify(params, unbind(keys, cfg, x))
    return uc_ops.unbind_classify(params["head"], keys, x)


def forward(params, keys: torch.Tensor, cfg: MIMONetConfig,
            images: torch.Tensor) -> torch.Tensor:
    """images: (N, K, H, W, 1) -> logits (N, K, n_classes): the five stages
    composed, the offline reference the served schedule must match."""
    codes = encode(params, cfg, images)
    x = trunk(params, superpose(keys, codes))
    return classify(params, unbind(keys, cfg, x))


def loss_fn(params, keys: torch.Tensor, cfg: MIMONetConfig, images: torch.Tensor,
            labels: torch.Tensor):
    """Per-channel cross-entropy in train-mode BN, staged as the reference
    (``classify(unbind(...))``, so its gradient runs through circ_conv's
    backward).  labels: (N, K).  Returns ``(loss, bn_stats)``."""
    bn_stats: dict = {}
    codes = encode(params, cfg, images, train=True, bn_stats=bn_stats)
    logits = classify(params, unbind(keys, cfg, trunk(params, superpose(keys, codes))))
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long()).mean(), bn_stats


def apply_bn_stats(params, bn_stats: dict, momentum: float = 0.9):
    """EMA-fold one step's encoder BN batch statistics into the running
    stats; returns a new params tree."""
    return {**params,
            "encoder": layers.bn_apply_stats(params["encoder"], bn_stats, momentum)}


def accuracy(params, keys: torch.Tensor, cfg: MIMONetConfig, images: torch.Tensor,
             labels: torch.Tensor) -> float:
    with torch.no_grad():
        logits = forward(params, keys, cfg, images)
    return float((logits.argmax(-1) == labels).float().mean())
