"""ResNet-18 (NHWC at its interface), the neural frontend of NVSA.

The port of ``repro.nn.resnet``: stages ``(2, 2, 2, 2)``, a projection
shortcut wherever the stride or width changes, and batchnorm in eval mode
(serving) or train mode (batch statistics, collected for the EMA fold).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn import layers


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    in_channels: int = 1
    width: int = 64  # stem width; stages are (w, 2w, 4w, 8w)
    blocks_per_stage: tuple[int, ...] = (2, 2, 2, 2)  # resnet18
    out_dim: int = 512
    dtype: object = torch.float32


def _block_spec(c_in: int, c_out: int, stride: int, dtype):
    spec = {
        "conv1": layers.conv2d_spec(c_in, c_out, 3, dtype=dtype),
        "bn1": layers.batchnorm_spec(c_out, dtype=dtype),
        "conv2": layers.conv2d_spec(c_out, c_out, 3, dtype=dtype),
        "bn2": layers.batchnorm_spec(c_out, dtype=dtype),
    }
    if stride != 1 or c_in != c_out:
        spec["proj"] = layers.conv2d_spec(c_in, c_out, 1, dtype=dtype)
        spec["proj_bn"] = layers.batchnorm_spec(c_out, dtype=dtype)
    return spec


def resnet_spec(cfg: ResNetConfig):
    w, dtype = cfg.width, cfg.dtype
    spec = {
        "stem": layers.conv2d_spec(cfg.in_channels, w, 7, dtype=dtype),
        "stem_bn": layers.batchnorm_spec(w, dtype=dtype),
        "stages": [],
        "head": layers.dense_spec(w * 8, cfg.out_dim, ("embed", "mlp"), bias=True,
                                  dtype=dtype),
    }
    c_in = w
    for si, n_blocks in enumerate(cfg.blocks_per_stage):
        c_out = w * (2 ** si)
        stage = []
        for bi in range(n_blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            stage.append(_block_spec(c_in, c_out, stride, dtype))
            c_in = c_out
        spec["stages"].append(stage)
    return spec


def _block(params, x, stride: int, train: bool, compute_dtype, bn_stats, path):
    def bn(name, y):
        return layers.batchnorm(params[name], y, train, stats_sink=bn_stats,
                                stats_key=path + (name,))

    y = layers.conv2d(params["conv1"], x, stride=stride, compute_dtype=compute_dtype)
    y = torch.relu(bn("bn1", y))
    y = layers.conv2d(params["conv2"], y, compute_dtype=compute_dtype)
    y = bn("bn2", y)
    if "proj" in params:
        x = bn("proj_bn", layers.conv2d(params["proj"], x, stride=stride,
                                        compute_dtype=compute_dtype))
    return torch.relu(x + y)


def resnet(params, cfg: ResNetConfig, images: torch.Tensor, train: bool = False,
           compute_dtype=torch.float32, bn_stats: dict | None = None) -> torch.Tensor:
    """images: (B, H, W, C) -> (B, out_dim).

    ``train=False`` uses the running stats, so each example's output is
    independent of its batch (serving).  ``train=True`` uses batch
    statistics; pass a ``bn_stats`` dict to collect each BN layer's batch
    mean / var under its path into ``params`` (``("stem_bn",)``,
    ``("stages", si, bi, "bn1")``), which ``layers.bn_apply_stats`` folds
    into the running stats."""
    x = layers.conv2d(params["stem"], images.to(compute_dtype), stride=2,
                      compute_dtype=compute_dtype)
    x = torch.relu(layers.batchnorm(params["stem_bn"], x, train, stats_sink=bn_stats,
                                    stats_key=("stem_bn",)))
    x = layers.maxpool2d(x, 3, 2)
    for si, stage in enumerate(params["stages"]):
        for bi, block in enumerate(stage):
            stride = 2 if (bi == 0 and si > 0) else 1
            x = _block(block, x, stride, train, compute_dtype, bn_stats, ("stages", si, bi))
    x = layers.avgpool_global(x)
    return layers.dense(params["head"], x, compute_dtype)
