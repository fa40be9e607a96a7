"""The paper's seven evaluation CNNs (port of ``repro/models/cnn.py``):
Inception-ResNet-V2, Inception-V3, MobileNet-V2, NASNet-mobile,
PNASNet-mobile, ResNet-152-V2 and VGG-19, with the reference's structure
and layer names, whose conv/fc compute flows through the SPRING ops, plus
the layer recorder that derives the per-layer (MACs, bytes) tables.

Activations are NHWC and conv weights HWIO, as in the reference, so its
parameters map one to one (``repro_torch.convert.cnn_params_from_jax``).
Parameters are created on first touch by :class:`ParamStore`, from a
per-name seed folded into the store's base seed (the reference folds
``hash(name)``, which changes from process to process).
:func:`cnn_layer_table` runs the model on the ``meta`` device: shapes
only, no memory and no arithmetic.
"""

from __future__ import annotations

import dataclasses
import threading
import zlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.spring_ops import conv_pads, pad_nhwc, spring_conv2d, spring_matmul
from repro_torch.kernels.prng import fold_in
from repro_torch.memstash.stash import checkpoint_apply
from repro_torch.models.layers import SpringContext


# --------------------------------------------------------------------------
# Layer recorder (perfmodel input).
# --------------------------------------------------------------------------


@dataclasses.dataclass
class LayerRecord:
    kind: str  # conv | fc
    name: str
    macs: int  # per-example multiply-accumulates
    in_elems: int
    w_elems: int
    out_elems: int


class _Recorder(threading.local):
    def __init__(self):
        self.records: Optional[list[LayerRecord]] = None


_REC = _Recorder()


def _record(r: LayerRecord):
    if _REC.records is not None:
        _REC.records.append(r)


def trace_layers(model_fn: Callable[[], torch.Tensor]) -> list[LayerRecord]:
    """Run ``model_fn`` (on meta tensors, for shapes only), collecting
    layer records."""
    _REC.records = []
    try:
        model_fn()
        return _REC.records
    finally:
        _REC.records = None


# --------------------------------------------------------------------------
# Parameterized building blocks (params created lazily per unique name).
# --------------------------------------------------------------------------


class ParamStore:
    """Name-addressed parameter store; init on first touch.

    ``key``: a 32-bit seed.  Each parameter is drawn from a generator on
    ``fold_in(key, crc32(name))``, on ``device`` (``meta`` gives shapes
    only), so a name's initial value does not depend on the order of
    first touches or on the process."""

    def __init__(self, key: int = 0, params: Optional[dict] = None, device=None):
        self.key = int(key)
        self.params = {} if params is None else params
        self.initializing = params is None
        self.device = torch.device("cpu" if device is None else device)

    def get(self, name: str, shape, scale: float) -> torch.Tensor:
        if name not in self.params:
            assert self.initializing, f"missing param {name}"
            shape = tuple(shape)
            if self.device.type == "meta" or scale == 0.0:
                p = torch.zeros(shape, device=self.device)
            else:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(fold_in(self.key, zlib.crc32(name.encode())))
                p = torch.randn(shape, generator=gen, device=self.device).mul_(scale)
            self.params[name] = p
        return self.params[name]


def conv(
    store: ParamStore,
    ctx: SpringContext,
    name: str,
    x: torch.Tensor,
    cout: int,
    k=3,
    stride: int = 1,
    groups: int = 1,
    relu: bool = True,
    padding: str = "SAME",
) -> torch.Tensor:
    cin = x.shape[-1]
    kh, kw = (k, k) if isinstance(k, int) else k
    w = store.get(name, (kh, kw, cin // groups, cout), scale=(2.0 / (kh * kw * cin)) ** 0.5)
    b = store.get(name + "/b", (cout,), 0.0)

    def body(x_, wb):
        w_, b_ = wb
        y_ = spring_conv2d(x_, w_, ctx.cfg, ctx.keys, stride=(stride, stride),
                           padding=padding, feature_group_count=groups)
        y_ = y_ + b_.to(y_.dtype)
        if relu:
            y_ = torch.relu(y_)  # the paper's activation-sparsity source
        return y_

    # The conv input is the previous layer's post-ReLU map: the sparse
    # tensor the backward dW GEMM re-reads, i.e. SPRING's stash target.
    y = checkpoint_apply(body, ctx.stash_policy(int(x.numel())), ctx.memstash,
                         name, x, (w, b))
    _record(LayerRecord(
        "conv", name,
        macs=int(y.shape[1] * y.shape[2] * cout * (kh * kw * cin // groups)),
        in_elems=int(x.shape[1] * x.shape[2] * cin),
        w_elems=int(kh * kw * (cin // groups) * cout),
        out_elems=int(y.shape[1] * y.shape[2] * cout),
    ))
    return y


def fc(store: ParamStore, ctx: SpringContext, name: str, x: torch.Tensor, cout: int,
       relu: bool = False) -> torch.Tensor:
    cin = x.shape[-1]
    w = store.get(name, (cin, cout), scale=(1.0 / cin) ** 0.5)
    b = store.get(name + "/b", (cout,), 0.0)

    def body(x_, wb):
        w_, b_ = wb
        y_ = spring_matmul(x_, w_, ctx.cfg, ctx.keys)
        y_ = y_ + b_.to(y_.dtype)
        return torch.relu(y_) if relu else y_

    y = checkpoint_apply(body, ctx.stash_policy(int(x.numel())), ctx.memstash,
                         name, x, (w, b))
    _record(LayerRecord("fc", name, macs=cin * cout, in_elems=cin,
                        w_elems=cin * cout, out_elems=cout))
    return y


def _pool_pads(x: torch.Tensor, k: int, stride: int, padding: str) -> list:
    return conv_pads(tuple(x.shape[1:3]), (k, k), (stride, stride), padding)


def maxpool(x, k=2, stride=2, padding="VALID"):
    """``lax.reduce_window`` max with the reference's pads (-inf)."""
    xp = pad_nhwc(x, _pool_pads(x, k, stride, padding), value=float("-inf"))
    return F.max_pool2d(xp.permute(0, 3, 1, 2), k, stride).permute(0, 2, 3, 1)


def avgpool(x, k, stride, padding="SAME"):
    """Window sum over zero pads, divided by k*k (the reference's
    ``reduce_window`` add then ``/ (k * k)``)."""
    xp = pad_nhwc(x, _pool_pads(x, k, stride, padding))
    s = F.avg_pool2d(xp.permute(0, 3, 1, 2), k, stride, divisor_override=1)
    return s.permute(0, 2, 3, 1) / (k * k)


def gap(x):
    return x.mean(dim=(1, 2))


def sep_conv(store, ctx, name, x, cout, k=3, stride=1, relu=True):
    """Depthwise-separable conv (MobileNet/NAS cells)."""
    cin = x.shape[-1]
    y = conv(store, ctx, name + "/dw", x, cin, k=k, stride=stride, groups=cin, relu=False)
    return conv(store, ctx, name + "/pw", y, cout, k=1, relu=relu)


# --------------------------------------------------------------------------
# The seven CNNs.
# --------------------------------------------------------------------------


def vgg19(store: ParamStore, ctx: SpringContext, x: torch.Tensor) -> torch.Tensor:
    plan = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]
    for bi, (c, n) in enumerate(plan):
        for li in range(n):
            x = conv(store, ctx, f"c{bi}_{li}", x, c, k=3)
        x = maxpool(x)
    x = x.reshape(x.shape[0], -1)
    x = fc(store, ctx, "fc6", x, 4096, relu=True)
    x = fc(store, ctx, "fc7", x, 4096, relu=True)
    return fc(store, ctx, "fc8", x, 1000)


def resnet152_v2(store: ParamStore, ctx: SpringContext, x: torch.Tensor) -> torch.Tensor:
    def bottleneck(x, name, width, stride):
        cin = x.shape[-1]
        cout = width * 4
        h = conv(store, ctx, name + "/1", x, width, k=1, relu=True)
        h = conv(store, ctx, name + "/2", h, width, k=3, stride=stride, relu=True)
        h = conv(store, ctx, name + "/3", h, cout, k=1, relu=False)
        if cin != cout or stride != 1:
            x = conv(store, ctx, name + "/sc", x, cout, k=1, stride=stride, relu=False)
        return torch.relu(x + h)

    x = conv(store, ctx, "stem", x, 64, k=7, stride=2)
    x = maxpool(x, 3, 2, "SAME")
    for si, (width, n, stride) in enumerate([(64, 3, 1), (128, 8, 2), (256, 36, 2), (512, 3, 2)]):
        for bi in range(n):
            x = bottleneck(x, f"s{si}b{bi}", width, stride if bi == 0 else 1)
    return fc(store, ctx, "head", gap(x), 1000)


def mobilenet_v2(store: ParamStore, ctx: SpringContext, x: torch.Tensor) -> torch.Tensor:
    def inv_res(x, name, expand, cout, stride):
        cin = x.shape[-1]
        h = x
        if expand != 1:
            h = conv(store, ctx, name + "/e", h, cin * expand, k=1)
        h = conv(store, ctx, name + "/dw", h, h.shape[-1], k=3, stride=stride,
                 groups=h.shape[-1])
        h = conv(store, ctx, name + "/p", h, cout, k=1, relu=False)
        if stride == 1 and cin == cout:
            h = x + h
        return h

    x = conv(store, ctx, "stem", x, 32, k=3, stride=2)
    plan = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    i = 0
    for t, c, n, s in plan:
        for bi in range(n):
            x = inv_res(x, f"b{i}", t, c, s if bi == 0 else 1)
            i += 1
    x = conv(store, ctx, "last", x, 1280, k=1)
    return fc(store, ctx, "head", gap(x), 1000)


def inception_v3(store: ParamStore, ctx: SpringContext, x: torch.Tensor) -> torch.Tensor:
    c = lambda n, x_, co, k=3, s=1, p="SAME", relu=True: conv(store, ctx, n, x_, co, k=k, stride=s, padding=p, relu=relu)

    # stem (299x299 -> 35x35x192)
    x = c("s1", x, 32, 3, 2, "VALID")
    x = c("s2", x, 32, 3, 1, "VALID")
    x = c("s3", x, 64, 3)
    x = maxpool(x, 3, 2)
    x = c("s4", x, 80, 1)
    x = c("s5", x, 192, 3, 1, "VALID")
    x = maxpool(x, 3, 2)

    def mixed_a(x, name, pool_ch):
        b0 = c(name + "/b0", x, 64, 1)
        b1 = c(name + "/b1b", c(name + "/b1a", x, 48, 1), 64, 5)
        b2 = c(name + "/b2c", c(name + "/b2b", c(name + "/b2a", x, 64, 1), 96, 3), 96, 3)
        b3 = c(name + "/b3", avgpool(x, 3, 1), pool_ch, 1)
        return torch.cat([b0, b1, b2, b3], -1)

    x = mixed_a(x, "m5b", 32)
    x = mixed_a(x, "m5c", 64)
    x = mixed_a(x, "m5d", 64)

    # reduction to 17x17
    b0 = c("r6/b0", x, 384, 3, 2, "VALID")
    b1 = c("r6/b1c", c("r6/b1b", c("r6/b1a", x, 64, 1), 96, 3), 96, 3, 2, "VALID")
    x = torch.cat([b0, b1, maxpool(x, 3, 2)], -1)

    def mixed_b(x, name, ch7):
        b0 = c(name + "/b0", x, 192, 1)
        b1 = c(name + "/b1c", c(name + "/b1b", c(name + "/b1a", x, ch7, 1), ch7, (1, 7)), 192, (7, 1))
        b2 = x
        for i, (co, k) in enumerate([(ch7, 1), (ch7, (7, 1)), (ch7, (1, 7)), (ch7, (7, 1)), (192, (1, 7))]):
            b2 = c(f"{name}/b2{i}", b2, co, k)
        b3 = c(name + "/b3", avgpool(x, 3, 1), 192, 1)
        return torch.cat([b0, b1, b2, b3], -1)

    for name, ch7 in [("m6b", 128), ("m6c", 160), ("m6d", 160), ("m6e", 192)]:
        x = mixed_b(x, name, ch7)

    # reduction to 8x8
    b0 = c("r7/b0b", c("r7/b0a", x, 192, 1), 320, 3, 2, "VALID")
    b1 = c("r7/b1c", c("r7/b1bb", c("r7/b1b", c("r7/b1a", x, 192, 1), 192, (1, 7)), 192, (7, 1)), 192, 3, 2, "VALID")
    x = torch.cat([b0, b1, maxpool(x, 3, 2)], -1)

    def mixed_c(x, name):
        b0 = c(name + "/b0", x, 320, 1)
        b1a = c(name + "/b1a", x, 384, 1)
        b1 = torch.cat([c(name + "/b1b", b1a, 384, (1, 3)), c(name + "/b1c", b1a, 384, (3, 1))], -1)
        b2a = c(name + "/b2b", c(name + "/b2a", x, 448, 1), 384, 3)
        b2 = torch.cat([c(name + "/b2c", b2a, 384, (1, 3)), c(name + "/b2d", b2a, 384, (3, 1))], -1)
        b3 = c(name + "/b3", avgpool(x, 3, 1), 192, 1)
        return torch.cat([b0, b1, b2, b3], -1)

    x = mixed_c(x, "m7b")
    x = mixed_c(x, "m7c")
    return fc(store, ctx, "head", gap(x), 1000)


def inception_resnet_v2(store: ParamStore, ctx: SpringContext, x: torch.Tensor) -> torch.Tensor:
    c = lambda n, x_, co, k=3, s=1, p="SAME", relu=True: conv(store, ctx, n, x_, co, k=k, stride=s, padding=p, relu=relu)
    # stem as inception v3 up to 35x35, widened to 320
    x = c("s1", x, 32, 3, 2, "VALID")
    x = c("s2", x, 32, 3, 1, "VALID")
    x = c("s3", x, 64, 3)
    x = maxpool(x, 3, 2)
    x = c("s4", x, 80, 1)
    x = c("s5", x, 192, 3, 1, "VALID")
    x = maxpool(x, 3, 2)
    x = c("s6", x, 320, 1)

    def block35(x, name):  # 10x
        b0 = c(name + "/b0", x, 32, 1)
        b1 = c(name + "/b1b", c(name + "/b1a", x, 32, 1), 32, 3)
        b2 = c(name + "/b2c", c(name + "/b2b", c(name + "/b2a", x, 32, 1), 48, 3), 64, 3)
        up = c(name + "/up", torch.cat([b0, b1, b2], -1), x.shape[-1], 1, relu=False)
        return torch.relu(x + 0.17 * up)

    for i in range(10):
        x = block35(x, f"a{i}")
    # reduction A -> 17x17, 1088ch
    b0 = c("ra/b0", x, 384, 3, 2, "VALID")
    b1 = c("ra/b1c", c("ra/b1b", c("ra/b1a", x, 256, 1), 256, 3), 384, 3, 2, "VALID")
    x = torch.cat([b0, b1, maxpool(x, 3, 2)], -1)

    def block17(x, name):  # 20x
        b0 = c(name + "/b0", x, 192, 1)
        b1 = c(name + "/b1c", c(name + "/b1b", c(name + "/b1a", x, 128, 1), 160, (1, 7)), 192, (7, 1))
        up = c(name + "/up", torch.cat([b0, b1], -1), x.shape[-1], 1, relu=False)
        return torch.relu(x + 0.1 * up)

    for i in range(20):
        x = block17(x, f"b{i}")
    # reduction B -> 8x8
    b0 = c("rb/b0b", c("rb/b0a", x, 256, 1), 384, 3, 2, "VALID")
    b1 = c("rb/b1b", c("rb/b1a", x, 256, 1), 288, 3, 2, "VALID")
    b2 = c("rb/b2c", c("rb/b2b", c("rb/b2a", x, 256, 1), 288, 3), 320, 3, 2, "VALID")
    x = torch.cat([b0, b1, b2, maxpool(x, 3, 2)], -1)

    def block8(x, name):  # 10x
        b0 = c(name + "/b0", x, 192, 1)
        b1 = c(name + "/b1c", c(name + "/b1b", c(name + "/b1a", x, 192, 1), 224, (1, 3)), 256, (3, 1))
        up = c(name + "/up", torch.cat([b0, b1], -1), x.shape[-1], 1, relu=False)
        return torch.relu(x + 0.2 * up)

    for i in range(10):
        x = block8(x, f"c{i}")
    x = c("final", x, 1536, 1)
    return fc(store, ctx, "head", gap(x), 1000)


def _nas_cell(store, ctx, name, x, filters, stride=1):
    """Simplified NASNet/PNASNet cell: parallel separable convs + pool."""
    h = conv(store, ctx, name + "/sq", x, filters, k=1)
    b1 = sep_conv(store, ctx, name + "/s3a", h, filters, k=3, stride=stride)
    b2 = sep_conv(store, ctx, name + "/s3b", h, filters, k=3, stride=stride)
    b3 = sep_conv(store, ctx, name + "/s5a", h, filters, k=5, stride=stride)
    b4 = sep_conv(store, ctx, name + "/s5b", h, filters, k=5, stride=stride)
    b5 = sep_conv(store, ctx, name + "/s7", h, filters, k=7, stride=stride)
    b6 = avgpool(h, 3, stride)
    return torch.cat([b1, b2, b3, b4, b5, b6], -1)


def _nas_net(store, ctx, x, base_filters: int, cells_per_stage: int):
    """NASNet/PNASNet-mobile skeleton: conv stem + 2 stem reduction cells
    (so normal cells run at 28x28, as published), then 3 stages of
    [N normal cells, reduction] with filter doubling."""
    x = conv(store, ctx, "stem", x, 32, k=3, stride=2)  # 112
    f = base_filters
    x = _nas_cell(store, ctx, "stem_r0", x, f // 2, stride=2)  # 56
    x = _nas_cell(store, ctx, "stem_r1", x, f, stride=2)  # 28
    for stage in range(3):
        for i in range(cells_per_stage):
            x = _nas_cell(store, ctx, f"n{stage}_{i}", x, f)
        if stage < 2:
            f *= 2
            x = _nas_cell(store, ctx, f"red{stage}", x, f, stride=2)
    return fc(store, ctx, "head", gap(x), 1000)


def nasnet_mobile(store, ctx, x):
    return _nas_net(store, ctx, x, base_filters=44, cells_per_stage=4)


def pnasnet_mobile(store, ctx, x):
    return _nas_net(store, ctx, x, base_filters=54, cells_per_stage=3)


# --------------------------------------------------------------------------
# Registry.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CNNDef:
    name: str
    fn: Callable
    input_hw: int
    train_batch: int = 32  # paper: TF-Slim defaults
    infer_batch: int = 100


PAPER_CNNS: dict[str, CNNDef] = {
    "inception_resnet_v2": CNNDef("inception_resnet_v2", inception_resnet_v2, 299),
    "inception_v3": CNNDef("inception_v3", inception_v3, 299),
    "mobilenet_v2": CNNDef("mobilenet_v2", mobilenet_v2, 224),
    "nasnet_mobile": CNNDef("nasnet_mobile", nasnet_mobile, 224),
    "pnasnet_mobile": CNNDef("pnasnet_mobile", pnasnet_mobile, 224),
    "resnet152_v2": CNNDef("resnet152_v2", resnet152_v2, 224),
    "vgg19": CNNDef("vgg19", vgg19, 224),
}


def cnn_init(key: int, cnn: CNNDef, input_hw: Optional[int] = None, *, device="cpu") -> dict:
    """Materialize params on ``device`` by a batch-1 dense forward
    (init-on-first-touch)."""
    store = ParamStore(key, device=device)
    hw = input_hw or cnn.input_hw
    with torch.no_grad():
        cnn.fn(store, SpringContext(), torch.zeros((1, hw, hw, 3), device=device))
    return store.params


def cnn_apply(params: dict, cnn: CNNDef, x: torch.Tensor, ctx: SpringContext) -> torch.Tensor:
    return cnn.fn(ParamStore(0, params), ctx, x)


def cnn_layer_table(cnn: CNNDef, input_hw: Optional[int] = None) -> list[LayerRecord]:
    """Per-layer MACs/bytes table at the paper's input resolution (a
    forward on the ``meta`` device: shapes only)."""
    hw = input_hw or cnn.input_hw

    def run():
        store = ParamStore(0, device="meta")
        x = torch.zeros((1, hw, hw, 3), device="meta")
        return cnn.fn(store, SpringContext(), x)

    return trace_layers(run)
