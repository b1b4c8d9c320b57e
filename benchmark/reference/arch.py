"""The DeepLabV3+ architecture as the benchmark's configurations state it:
every tensor (name, shape, how it is initialised) and every stride-1
separable unit (its scope, pixels, widths, dilation and form).

Names follow the port's ``state_dict`` (the JAX parameter tree:
``xception.block4.sepconv1.depthwise.weight``), so the map from the plain
reference's tensors to the port's is the identity; ``tests/
test_bench_reference.py`` holds the two lists equal.  The architecture is
the one of mlcommons/hpc ``deepcam/src/deepCam/architecture/
deeplab_xception.py`` (``DeepLabv3_plus``), which DeepLabV3+ (Chen et al.,
arXiv:1802.02611) publishes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

# ASPP rates by output stride
ASPP_RATES = {16: (1, 6, 12, 18), 8: (1, 12, 24, 36)}


@dataclass(frozen=True)
class Block:
    """An Xception block: ``units`` lists each [ReLU →] sepconv → BN unit's
    output width; ``tail`` is None, "sepconv_stride" or "sepconv_last"."""

    name: str
    cin: int
    cout: int
    units: Tuple[int, ...]
    stride: int
    dilation: int
    start_with_relu: bool
    tail: object
    skip: bool


def blocks(output_stride: int) -> List[Block]:
    """The 20 blocks of the modified aligned Xception."""
    if output_stride == 16:
        b3_stride, middle, exit_rate = 2, 1, 1
    elif output_stride == 8:
        b3_stride, middle, exit_rate = 1, 2, 2
    else:
        raise ValueError(f"output stride {output_stride}")
    out = [Block("block1", 64, 128, (128, 128), 2, 1, False, "sepconv_stride", True),
           Block("block2", 128, 256, (256, 256), 2, 1, True, "sepconv_stride", True),
           Block("block3", 256, 728, (728, 728), b3_stride, 1, True,
                 "sepconv_stride" if b3_stride == 2 else "sepconv_last", True)]
    out += [Block(f"block{i}", 728, 728, (728, 728, 728), 1, middle, True, None, False)
            for i in range(4, 20)]
    out.append(Block("block20", 728, 1024, (728, 1024), 1, exit_rate, True, "sepconv_last",
                     True))
    return out


def exit_rate(output_stride: int) -> int:
    """The dilation of conv3..conv5."""
    return {16: 2, 8: 4}[output_stride]


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """[(name, shape, init)] of every tensor of the model, in the port's
    ``state_dict`` order.  ``init``: "kaiming" (normal, std sqrt(2/fan_in)),
    "uniform" (U(+-1/sqrt(fan_in)), PyTorch's default), "bias:<fan_in>",
    "ones", "zeros"; fan_in = shape[1]*kh*kw, as torch computes it (for a
    transposed conv's (I, O, kh, kw) weight that is O*kh*kw)."""
    os_, n_cls, cin = cfg["output_stride"], cfg["n_classes"], cfg["in_channels"]
    out = []

    def conv(name, o, i, k, init="kaiming", bias=False):
        out.append((f"{name}.weight", (o, i, k, k), init))
        if bias:
            out.append((f"{name}.bias", (o,), f"bias:{i * k * k}"))

    def bn(name, c):
        out.extend([(f"{name}.weight", (c,), "ones"), (f"{name}.bias", (c,), "zeros"),
                    (f"{name}.running_mean", (c,), "zeros"),
                    (f"{name}.running_var", (c,), "ones")])

    def sep(name, c, f):
        conv(f"{name}.depthwise", c, 1, 3)
        conv(f"{name}.pointwise", f, c, 1)

    conv("xception.conv1", 32, cin, 3)
    bn("xception.bn1", 32)
    conv("xception.conv2", 64, 32, 3)
    bn("xception.bn2", 64)
    for b in blocks(os_):
        p, c = f"xception.{b.name}", b.cin
        for i, f in enumerate(b.units):
            sep(f"{p}.sepconv{i}", c, f)
            bn(f"{p}.bn{i}", f)
            c = f
        if b.tail:
            sep(f"{p}.{b.tail}", c, b.cout)
        if b.skip:
            conv(f"{p}.skip_conv", b.cout, b.cin, 1)
            bn(f"{p}.skip_bn", b.cout)
    for i, (c, f) in zip((3, 4, 5), ((1024, 1536), (1536, 1536), (1536, 2048))):
        sep(f"xception.conv{i}", c, f)
        bn(f"xception.bn{i}", f)
    for i, r in enumerate(ASPP_RATES[os_]):
        conv(f"aspp{i + 1}.atrous_conv", 256, 2048, 1 if r == 1 else 3)
        bn(f"aspp{i + 1}.bn", 256)
    conv("gap_conv", 256, 2048, 1, "uniform")
    bn("gap_bn", 256)
    conv("conv1", 256, 1280, 1, "uniform")
    bn("bn1", 256)
    conv("conv2", 48, 128, 1, "uniform")
    bn("bn2", 48)
    if cfg["decoder"] == "deconv":
        out.append(("upsample.deconv1.weight", (256, 256, 3, 3), "uniform"))
        bn("upsample.deconv1_bn", 256)
        out.append(("upsample.deconv2.weight", (256, 256, 3, 3), "uniform"))
        bn("upsample.deconv2_bn", 256)
        conv("upsample.conv0", 256, 304, 3, "uniform")
        bn("upsample.bn0", 256)
        conv("upsample.conv1", 256, 256, 3, "uniform")
        bn("upsample.bn1", 256)
        conv("upsample.conv2", 256, 256, 1, "uniform", bias=True)
        out.append(("upsample.deconv3.weight", (256, 256, 3, 3), "uniform"))
        bn("upsample.deconv3_bn", 256)
        out.append(("upsample.last_deconv.weight", (256, n_cls, 3, 3), "uniform"))
    elif cfg["decoder"] == "interpolation":
        conv("upsample.conv0", 256, 304, 3, "uniform")
        bn("upsample.bn0", 256)
        conv("upsample.conv1", 256, 256, 3, "uniform")
        bn("upsample.bn1", 256)
        conv("upsample.conv2", n_cls, 256, 1, "uniform", bias=True)
    else:
        raise ValueError(f"decoder {cfg['decoder']!r}")
    return out


def is_buffer(name: str) -> bool:
    return name.endswith((".running_mean", ".running_var"))


def sepconv_units(cfg: dict, batch: int) -> List[Tuple[str, int, int, int, int, str]]:
    """[(scope, P, C, F, dilation, form)] of every stride-1 separable unit of
    one training forward on a local ``batch``: ``scope`` is the unit's module
    path (``xception/block5/sepconv0``), P its pixels, C→F its widths.

    ``form`` names the unit's work under the configuration's fold setting
    (``bn_fold``: the JAX default configuration): a unit whose input is the
    previous unit's raw output takes that BN's apply ("affine"); unit 0 of
    blocks 5..20 also forms the block boundary (residual add and ReLU,
    "boundary"); a train-mode unit followed by a BN emits its statistics
    ("_stats"); the first unit of a chain reads its input as it is
    ("base"/"stats")."""
    h, w = cfg["image_size"]
    fold = cfg["bn_fold"]
    os_ = cfg["output_stride"]
    res = (h // 2, w // 2)  # after conv1 (stride 2)
    out = []

    def form(affine, boundary, stats):
        if boundary:
            return "boundary_stats" if stats else "boundary"
        if affine:
            return "affine_stats" if stats else "affine"
        return "stats" if stats else "base"

    for b in blocks(os_):
        p = batch * res[0] * res[1]
        c = b.cin
        idx = int(b.name[5:])
        boundary_in = fold and 5 <= idx <= 20
        for i, f in enumerate(b.units):
            out.append((f"xception/{b.name}/sepconv{i}", p, c, f, b.dilation,
                        form(fold and i > 0, boundary_in and i == 0, True)))
            c = f
        if b.tail == "sepconv_last":
            out.append((f"xception/{b.name}/sepconv_last", p, c, b.cout, 1,
                        form(fold, False, False)))
        if b.stride == 2:
            res = (res[0] // 2, res[1] // 2)
    p = batch * res[0] * res[1]
    d = exit_rate(os_)
    for i, (c, f) in zip((3, 4, 5), ((1024, 1536), (1536, 1536), (1536, 2048))):
        out.append((f"xception/conv{i}", p, c, f, d, form(fold and i > 3, False, True)))
    return out
