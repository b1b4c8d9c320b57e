"""FC-DenseNet, the "One Hundred Layers Tiramisu" (Jégou et al.,
arXiv:1611.09326; github.com/SimJeg/FC-DenseNet): its tensors and plain fp32
forward (``reference/fcdensenet.py``), the port's ``FCDenseNet103``, and the
dense layers that ``dense_roofline`` reads.  A configuration of this family
names ``growth_rate``, ``first_conv``, ``layers_per_block``, ``dropout`` and
``dropout_seed``.
"""

from __future__ import annotations

from benchmark.frozen.roofline import PEAK_BF16_TENSOR, bound_s
from benchmark.reference import fcdensenet as ref

param_specs = ref.param_specs
is_buffer = ref.is_buffer
forward = ref.forward


def build(cfg: dict, device):
    """The port's ``FCDenseNet103`` at the configuration's widths, built on
    the meta device and given uninitialised storage on ``device``; its
    ``seed`` keys the dropout masks (the weights are loaded after)."""
    import torch

    from deepcam_tpu_torch.models.tiramisu import FCDenseNet103

    with torch.device("meta"):
        net = FCDenseNet103(cfg["n_classes"], in_ch=cfg["in_channels"],
                            growth_rate=cfg["growth_rate"], first_conv=cfg["first_conv"],
                            layers_per_block=cfg["layers_per_block"], dropout=cfg["dropout"],
                            dtype=getattr(torch, cfg["compute_dtype"]), device="meta",
                            seed=cfg["dropout_seed"])
    return net.to_empty(device=device)


def layout(cfg: dict) -> dict:
    """``head``: the last dense layer's conv and the classifier, which the
    loss's gradient reaches through no BN backward (through a dropout mask
    that both sides draw alike); no separable units; ``input_bn``: the
    first dense layer's BN, over the first conv's output."""
    last = len(cfg["layers_per_block"]) // 2 - 1
    conv = f"up{last}.layers.{cfg['layers_per_block'][-1] - 1}.conv"
    bn = "down0.layers.0.bn"
    return {"head": [f"{conv}.weight", f"{conv}.bias", "classifier.weight", "classifier.bias"],
            "units": [], "input_bn": [f"{bn}.running_mean", f"{bn}.running_var"]}


def dense_layer_bounds(c_in: int, growth: int, pixels: int) -> tuple:
    """(forward, backward) least seconds of one dense layer's 3x3 conv on
    ``pixels`` (batch x pixels at its level), bf16: the forward reads the
    C_in-channel input and writes the ``growth`` new channels, 2·9·C_in·g
    FLOPs a pixel; the backward reads the input and the new channels'
    gradient and writes the input's gradient, twice the forward's FLOPs.
    Each the larger of bytes over 3.35 TB/s and FLOPs over 989 TFLOP/s."""
    flops = 2 * 9 * c_in * growth * pixels
    fwd = bound_s(2 * pixels * (c_in + growth), [(flops, PEAK_BF16_TENSOR)])
    bwd = bound_s(2 * pixels * (2 * c_in + growth), [(2 * flops, PEAK_BF16_TENSOR)])
    return fwd, bwd


def units(cfg: dict, batch: int) -> list:
    """The dense layers, as the module paths under which the frozen module
    scopes can place their kernels: per layer ``(path, least seconds of its
    forward and backward)`` on the layer's own path, where its dropout and
    concatenation run, and ``(path, 0.0)`` on its BN's and its conv's.
    ``model.elementwise_ms`` leaves out every scope of a family's units, so
    in this family it reads only the work outside the dense layers."""
    p, g = ref.plan(cfg), cfg["growth_rate"]
    h, w = cfg["image_size"]
    blocks = ([(f"down{i}", c, n, i) for i, (c, n) in enumerate(p["down"])]
              + [("bottleneck", *p["bottleneck"], p["n_pool"])]
              + [(f"up{i}", c, n, p["n_pool"] - 1 - i) for i, (c, n) in enumerate(p["up"])])
    out = []
    for name, c, n, level in blocks:
        pixels = batch * (h >> level) * (w >> level)
        for i in range(n):
            path = f"{name}/layers/{i}"
            out += [(path, sum(dense_layer_bounds(c + i * g, g, pixels))),
                    (f"{path}/bn", 0.0), (f"{path}/conv", 0.0)]
    return out


def faults(cfg: dict) -> list:
    """Half a batch; every gradient scaled (no fused sepconv backward)."""
    return ["half_batch", "grad_scaled"]

