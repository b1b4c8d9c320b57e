"""DeepLabV3+ with the modified aligned Xception (mlcommons/hpc ``deepcam``
``src/deepCam/architecture/deeplab_xception.py``; Chen et al.,
arXiv:1802.02611): its tensors and separable units (``reference/arch.py``),
its plain fp32 forward (``reference/model.py``) and the port's
``DeepLabv3plus``.  A configuration of this family names its
``output_stride`` (16 or 8) and ``decoder`` ("deconv" or "interpolation").
"""

from __future__ import annotations

from benchmark.reference import arch, model

param_specs = arch.param_specs
is_buffer = arch.is_buffer
forward = model.forward
units = arch.sepconv_units

# the input's first BatchNorm, after the stride-2 stem convolution
INPUT_BN = "xception.bn1"
# the tensors after the decoder's last BatchNorm
HEAD = {"deconv": ["upsample.last_deconv.weight"],
        "interpolation": ["upsample.conv2.weight", "upsample.conv2.bias"]}


def build(cfg: dict, device):
    """The port's ``DeepLabv3plus`` at the configuration's widths, built on
    the meta device and given uninitialised storage on ``device``."""
    import torch

    from deepcam_tpu_torch.models.deeplab import DeepLabv3plus

    with torch.device("meta"):
        net = DeepLabv3plus(cfg["n_classes"], cfg["output_stride"], decoder=cfg["decoder"],
                            in_ch=cfg["in_channels"],
                            dtype=getattr(torch, cfg["compute_dtype"]), device="meta")
    return net.to_empty(device=device)


def layout(cfg: dict) -> dict:
    """``head``: the decoder's tensors after its last BN, which the loss's
    gradient reaches through no BN backward; ``units``: each separable
    convolution's (depthwise, pointwise) weights, the stride-2 ones
    included, in the model's order; ``input_bn``: the stem's first BN's two
    running statistics."""
    names = [n for n, _, _ in param_specs(cfg)]
    units = [(n, n[:-len("depthwise.weight")] + "pointwise.weight") for n in names
             if n.endswith(".depthwise.weight")]
    return {"head": list(HEAD[cfg["decoder"]]), "units": units,
            "input_bn": [f"{INPUT_BN}.running_mean", f"{INPUT_BN}.running_var"]}


def faults(cfg: dict) -> list:
    """Half a batch; every gradient scaled; the fused sepconv backward's
    pointwise-weight and input gradients scaled where they are made."""
    return ["half_batch", "grad_scaled", "dpw_scaled", "dx_scaled"]
