"""The ResNet family — counterpart of ``beforeholiday_tpu/models/resnet.py``.

Functional, as there: :func:`init` returns a params tree and a BN-state tree
(running statistics, fp32), and :func:`forward` takes both and returns the
logits and the new BN state. Parameter names are torch's (``conv1``,
``bn1``, ``layer1.0.downsample_bn``), so amp's ``keep_batchnorm_fp32`` name
rule keeps every BatchNorm fp32, as it does for the JAX model.

Layouts are the JAX package's at every public boundary:

* the input is NHWC (N, H, W, C). Inside, the activations are logical NCHW
  tensors in ``torch.channels_last`` memory: ``x.permute(0, 3, 1, 2)`` of an
  NHWC tensor is exactly that, with no copy, and cuDNN convolves it as NHWC;
* conv weights are stored HWIO (kh, kw, cin, cout), so the parameter arena
  is laid out as JAX's, offset for offset. Each convolution permutes its
  weight to OIHW in channels-last memory for ``F.conv2d``: one copy of the
  weight per convolution per step.

The convolutions are cuDNN through ``F.conv2d`` and the pooling is
``F.max_pool2d``: the JAX package leaves both to XLA
(``conv_general_dilated``, ``reduce_window``) and writes no kernel for them.
BatchNorm is :func:`~beforeholiday_tpu_torch.parallel.sync_batch_norm`.
:func:`from_torch_state_dict` loads a torchvision-style ``state_dict``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from beforeholiday_tpu_torch.ops._dispatch import resolve_device
from beforeholiday_tpu_torch.parallel.sync_batch_norm import (
    BatchNormParams,
    BatchNormState,
    init_batch_norm,
    sync_batch_norm,
)
from beforeholiday_tpu_torch.testing._model_utils import (  # noqa: F401
    params_from_numpy,
    state_from_numpy,
)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """Architecture knobs. Presets below match torchvision's resnet18..152."""

    block: str  # "basic" | "bottleneck"
    layers: Tuple[int, ...]  # blocks per stage
    width: int = 64  # stem output channels
    num_classes: int = 1000
    stem_kernel: int = 7
    stem_stride: int = 2
    stem_pool: bool = True  # 3x3/2 maxpool after the stem
    zero_init_residual: bool = False  # torchvision flag: last-BN scale = 0

    @property
    def expansion(self) -> int:
        return 1 if self.block == "basic" else 4

    def stage_channels(self) -> Tuple[int, ...]:
        return tuple(self.width * (2**i) for i in range(len(self.layers)))


def resnet18(**kw) -> ResNetConfig:
    return ResNetConfig(block="basic", layers=(2, 2, 2, 2), **kw)


def resnet34(**kw) -> ResNetConfig:
    return ResNetConfig(block="basic", layers=(3, 4, 6, 3), **kw)


def resnet50(**kw) -> ResNetConfig:
    return ResNetConfig(block="bottleneck", layers=(3, 4, 6, 3), **kw)


def resnet101(**kw) -> ResNetConfig:
    return ResNetConfig(block="bottleneck", layers=(3, 4, 23, 3), **kw)


def resnet152(**kw) -> ResNetConfig:
    return ResNetConfig(block="bottleneck", layers=(3, 8, 36, 3), **kw)


def tiny_test_config(num_classes: int = 10) -> ResNetConfig:
    """Small net for CPU tests: 16x16 inputs, two stages."""
    return ResNetConfig(
        block="basic", layers=(1, 1), width=8, num_classes=num_classes,
        stem_kernel=3, stem_stride=1, stem_pool=False,
    )


CONFIGS = {
    "resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50,
    "resnet101": resnet101, "resnet152": resnet152,
}


# ---------------------------------------------------------------- init


def init(cfg: ResNetConfig, generator: torch.Generator, in_channels: int = 3,
         device=None):
    """Returns ``(params, bn_state)`` with the reference's shapes and
    distributions: Kaiming-normal (fan_out, ReLU gain) HWIO convs, BN scale 1
    and bias 0 (scale 0 on each block's last BN with
    ``zero_init_residual``), running mean 0 and variance 1, and ``fc``
    uniform in ±1/sqrt(fan_in). Draws on ``generator``'s device, then moves
    to ``device``."""
    device = resolve_device(device)

    def conv(kh, kw, cin, cout):
        std = math.sqrt(2.0 / (kh * kw * cout))
        t = torch.randn((kh, kw, cin, cout), generator=generator,
                        device=generator.device)
        return (t * std).to(device)

    def bn(c, zero_scale=False):
        params, state = init_batch_norm(c, device=device)
        if zero_scale:
            params = BatchNormParams(torch.zeros_like(params.scale), params.bias)
        return params, state

    def block(cin, cout, stride):
        p: Dict[str, Any] = {}
        s: Dict[str, Any] = {}
        zir = cfg.zero_init_residual
        if cfg.block == "basic":
            out_c = cout
            p["conv1"] = conv(3, 3, cin, cout)
            p["bn1"], s["bn1"] = bn(cout)
            p["conv2"] = conv(3, 3, cout, cout)
            p["bn2"], s["bn2"] = bn(cout, zero_scale=zir)
        else:
            out_c = cout * 4
            p["conv1"] = conv(1, 1, cin, cout)
            p["bn1"], s["bn1"] = bn(cout)
            p["conv2"] = conv(3, 3, cout, cout)
            p["bn2"], s["bn2"] = bn(cout)
            p["conv3"] = conv(1, 1, cout, out_c)
            p["bn3"], s["bn3"] = bn(out_c, zero_scale=zir)
        if stride != 1 or cin != out_c:
            p["downsample_conv"] = conv(1, 1, cin, out_c)
            p["downsample_bn"], s["downsample_bn"] = bn(out_c)
        return p, s

    p: Dict[str, Any] = {"conv1": conv(cfg.stem_kernel, cfg.stem_kernel,
                                       in_channels, cfg.width)}
    s: Dict[str, Any] = {}
    p["bn1"], s["bn1"] = bn(cfg.width)
    cin = cfg.width
    for i, (n_blocks, cout) in enumerate(zip(cfg.layers, cfg.stage_channels())):
        stage_p, stage_s = {}, {}
        for j in range(n_blocks):
            stride = 2 if (j == 0 and i > 0) else 1
            stage_p[str(j)], stage_s[str(j)] = block(cin, cout, stride)
            cin = cout * cfg.expansion
        p[f"layer{i + 1}"] = stage_p
        s[f"layer{i + 1}"] = stage_s
    bound = 1.0 / math.sqrt(cin)

    def uniform(shape):
        t = torch.rand(shape, generator=generator, device=generator.device)
        return ((2.0 * t - 1.0) * bound).to(device)

    p["fc"] = {"w": uniform((cin, cfg.num_classes)), "b": uniform((cfg.num_classes,))}
    return p, s


# ------------------------------------------------------------- forward


def _conv(x, w, stride=1):
    """Convolution of an NCHW (channels-last) activation with an HWIO
    weight, torch's symmetric padding ((k-1)//2); the weight is cast to the
    activation's dtype first, as JAX casts it."""
    kh, kw = w.shape[0], w.shape[1]
    w = w.to(x.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return F.conv2d(x, w, stride=stride, padding=((kh - 1) // 2, (kw - 1) // 2))


def _maxpool_3x3_s2(x):
    # torch pads max-pooling with -inf, as JAX's reduce_window does here
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def _apply_bn(x, bp, bs, training, momentum, axis_name, fuse_relu=False):
    return sync_batch_norm(x, bp, bs, training=training, momentum=momentum,
                           axis_name=axis_name, fuse_relu=fuse_relu)


def _block_forward(cfg, p, s, x, stride, *, training, momentum, axis_name):
    new_s: Dict[str, Any] = {}
    identity = x
    if cfg.block == "basic":
        y = _conv(x, p["conv1"], stride)
        y, new_s["bn1"] = _apply_bn(y, p["bn1"], s["bn1"], training, momentum,
                                    axis_name, fuse_relu=True)
        y = _conv(y, p["conv2"], 1)
        y, new_s["bn2"] = _apply_bn(y, p["bn2"], s["bn2"], training, momentum,
                                    axis_name)
    else:
        y = _conv(x, p["conv1"], 1)
        y, new_s["bn1"] = _apply_bn(y, p["bn1"], s["bn1"], training, momentum,
                                    axis_name, fuse_relu=True)
        y = _conv(y, p["conv2"], stride)
        y, new_s["bn2"] = _apply_bn(y, p["bn2"], s["bn2"], training, momentum,
                                    axis_name, fuse_relu=True)
        y = _conv(y, p["conv3"], 1)
        y, new_s["bn3"] = _apply_bn(y, p["bn3"], s["bn3"], training, momentum,
                                    axis_name)
    if "downsample_conv" in p:
        identity = _conv(x, p["downsample_conv"], stride)
        identity, new_s["downsample_bn"] = _apply_bn(
            identity, p["downsample_bn"], s["downsample_bn"], training,
            momentum, axis_name)
    return torch.relu(y + identity), new_s


def forward(
    params: Any,
    bn_state: Any,
    x: torch.Tensor,
    cfg: ResNetConfig,
    *,
    training: bool = True,
    momentum: float = 0.1,
    axis_name: Optional[str] = None,
) -> Tuple[torch.Tensor, Any]:
    """x: (N, H, W, C) NHWC. Returns ``(logits in x's dtype, new_bn_state)``.
    ``axis_name`` (an axis name or a ``ProcessGroup``) makes every
    BatchNorm a SyncBN across that group (``parallel.sync_batch_norm``)."""
    y = x.permute(0, 3, 1, 2)  # logical NCHW, channels-last memory
    new_s: Dict[str, Any] = {}
    y = _conv(y, params["conv1"], cfg.stem_stride)
    y, new_s["bn1"] = _apply_bn(y, params["bn1"], bn_state["bn1"], training,
                                momentum, axis_name, fuse_relu=True)
    if cfg.stem_pool:
        y = _maxpool_3x3_s2(y)
    for i in range(len(cfg.layers)):
        name = f"layer{i + 1}"
        stage_new = {}
        for j in range(cfg.layers[i]):
            stride = 2 if (j == 0 and i > 0) else 1
            y, stage_new[str(j)] = _block_forward(
                cfg, params[name][str(j)], bn_state[name][str(j)], y, stride,
                training=training, momentum=momentum, axis_name=axis_name)
        new_s[name] = stage_new
    # global average pool: an fp32 sum, one rounding to the activations'
    # dtype (jnp.mean's upcast)
    y = y.mean(dim=(2, 3), dtype=torch.float32).to(y.dtype)
    logits = y @ params["fc"]["w"].to(y.dtype) + params["fc"]["b"].to(y.dtype)
    return logits, new_s


# ------------------------------------------------- torchvision state dicts


def from_torch_state_dict(cfg: ResNetConfig, sd: Dict[str, Any], device=None):
    """Map a torchvision ResNet ``state_dict()`` (tensors or numpy arrays)
    to ``(params, bn_state)`` in fp32 on ``device`` (default: ``cuda``, or
    the CPU when asked), as the JAX package's ``from_torch_state_dict``
    does: conv weights (O, I, H, W) -> (H, W, I, O), fc (O, I) -> (I, O).
    Every tensor is a copy, so the module the state dict came from shares
    no storage with the result."""
    device = resolve_device(device)

    def arr(t):
        return torch.as_tensor(t).detach().to(device=device, dtype=torch.float32,
                                              copy=True)

    def conv_w(name):
        return arr(sd[name + ".weight"]).permute(2, 3, 1, 0).contiguous()

    def bn(name):
        return (BatchNormParams(arr(sd[name + ".weight"]), arr(sd[name + ".bias"])),
                BatchNormState(arr(sd[name + ".running_mean"]),
                               arr(sd[name + ".running_var"])))

    p: Dict[str, Any] = {"conv1": conv_w("conv1")}
    s: Dict[str, Any] = {}
    p["bn1"], s["bn1"] = bn("bn1")
    n_convs = 2 if cfg.block == "basic" else 3
    for i in range(len(cfg.layers)):
        lp, ls = {}, {}
        for j in range(cfg.layers[i]):
            bp, bs = {}, {}
            base = f"layer{i + 1}.{j}"
            for c in range(1, n_convs + 1):
                bp[f"conv{c}"] = conv_w(f"{base}.conv{c}")
                bp[f"bn{c}"], bs[f"bn{c}"] = bn(f"{base}.bn{c}")
            if f"{base}.downsample.0.weight" in sd:
                bp["downsample_conv"] = conv_w(f"{base}.downsample.0")
                bp["downsample_bn"], bs["downsample_bn"] = bn(f"{base}.downsample.1")
            lp[str(j)], ls[str(j)] = bp, bs
        p[f"layer{i + 1}"], s[f"layer{i + 1}"] = lp, ls
    p["fc"] = {"w": arr(sd["fc.weight"]).t().contiguous(), "b": arr(sd["fc.bias"])}
    return p, s
