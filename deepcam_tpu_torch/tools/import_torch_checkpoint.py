"""Import pretrained Xception weights into the port's backbone, and turn a
checkpoint into a port checkpoint (counterpart of the pretrained half and
the CLI of ``deepcam_tpu/tools/import_torch_checkpoint.py``).

The reference's ``Xception.__load_xception_pretrained`` loads the cadene
ImageNet Xception ``.pth`` into its backbone with a key remap
(block12→block20, block11→block12, bn3→{bn3, bn4}, conv4→conv5, bn4→bn5;
pointwise weights reshaped to 1x1) and keeps only the keys its model has.
``import_pretrained_xception`` lands the same tensors as the JAX package's
importer does for the same dict:

* a block's rep children pair with the port's units by order (the i-th
  separable conv of the source with ``sepconv<i>``, then the block's tail;
  the i-th BN with ``bn<i>``), not by index;
* a block whose source has another number of separable convs or BNs than
  the port's block (counting its tail) lands nothing, its skip included: a
  cadene file's max-pooling blocks 1-3 and its two-unit block12;
* a tensor whose shape differs keeps the port's init (the cadene conv1
  reads 3 channels, the port's 16);
* only backbone (``xception_features.``) tensors land.

Layouts agree (OIHW, depthwise (C, 1, 3, 3)), so a tensor lands as it is,
cast to the port's type.  No weights are downloaded: the caller passes the
file.

    python -m deepcam_tpu_torch.tools.import_torch_checkpoint \\
        --pretrained_backbone --checkpoint xception-43020ad28.pth --output init.cpt

writes a step-0 port checkpoint that ``cli/train.py --checkpoint init.cpt``
restores.  Without ``--pretrained_backbone`` the input is a training
checkpoint in the reference's schema, written back in the port's.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

import torch

from .. import resolve_device
from .ref_names import BN_KEYS, bn_names, conv_names, sep_names

PREFIX = "xception_features."


def cadene_xception_shapes(n_classes: int = 1000) -> Dict[str, Tuple[int, ...]]:
    """{key: shape} of the cadene ImageNet Xception state_dict, the file the
    reference loads: 3-channel conv1, blocks 1-3 and 12 ending in a max
    pool (two separable convs, a strided skip), eight 728-channel middle
    blocks, conv3/bn3 (1536) and conv4/bn4 (2048) and the classifier ``fc``;
    pointwise weights 2-D, as the published file holds them."""
    shapes: Dict[str, Tuple[int, ...]] = {"conv1.weight": (32, 3, 3, 3),
                                          "conv2.weight": (64, 32, 3, 3)}

    def bn(name, c):
        shapes.update({f"{name}.{k}": (c,) for k in BN_KEYS})

    def sep(name, c, f):
        shapes[f"{name}.conv1.weight"] = (c, 1, 3, 3)
        shapes[f"{name}.pointwise.weight"] = (f, c)

    bn("bn1", 32)
    bn("bn2", 64)
    # (block, in, out, reps, start_with_relu, grow_first, strided)
    blocks = [(1, 64, 128, 2, False, True, True), (2, 128, 256, 2, True, True, True),
              (3, 256, 728, 2, True, True, True)]
    blocks += [(i, 728, 728, 3, True, True, False) for i in range(4, 12)]
    blocks.append((12, 728, 1024, 2, True, False, True))
    for i, cin, cout, reps, relu, grow, strided in blocks:
        # rep: [ReLU, SeparableConv2d, BN] per unit, without the first ReLU
        # when the block does not start with one, then a MaxPool2d
        if grow:
            units = [(cin, cout)] + [(cout, cout)] * (reps - 1)
        else:
            units = [(cin, cin)] * (reps - 1) + [(cin, cout)]
        first = 1 if relu else 0
        for u, (c, f) in enumerate(units):
            sep(f"block{i}.rep.{3 * u + first}", c, f)
            bn(f"block{i}.rep.{3 * u + first + 1}", f)
        if strided or cin != cout:
            shapes[f"block{i}.skip.weight"] = (cout, cin, 1, 1)
            bn(f"block{i}.skipbn", cout)
    sep("conv3", 1024, 1536)
    bn("bn3", 1536)
    sep("conv4", 1536, 2048)
    bn("bn4", 2048)
    shapes["fc.weight"] = (n_classes, 2048)
    shapes["fc.bias"] = (n_classes,)
    return shapes


def remap_pretrained_keys(pretrain_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference's key remap: block12→block20, block11→block12,
    bn3→{bn3, bn4}, conv4→conv5, bn4→bn5; a 2-D pointwise weight (O, I)
    becomes (O, I, 1, 1).  Keys the backbone lacks stay, for the caller's
    match to drop."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in pretrain_dict.items():
        if "pointwise" in k and v.dim() == 2:
            v = v[:, :, None, None]
        if k.startswith("block12"):
            out[k.replace("block12", "block20")] = v
        elif k.startswith("block11"):
            out[k.replace("block11", "block12")] = v
        elif k.startswith("bn3"):
            out[k] = v
            out[k.replace("bn3", "bn4")] = v
        elif k.startswith("conv4"):
            out[k.replace("conv4", "conv5")] = v
        elif k.startswith("bn4"):
            out[k.replace("bn4", "bn5")] = v
        else:
            out[k] = v
    return out


def _rep_indices(keys, rep: str, suffix: str) -> List[int]:
    return sorted({int(k[len(rep):].split(".")[0]) for k in keys
                   if k.startswith(rep) and k.endswith(suffix)})


def _block_pairs(keys, port: str, src: str, block) -> List[Tuple[str, str]]:
    """(port key, source key) of one block, paired by order; none when the
    source's rep differs in its numbers of separable convs or BNs."""
    rep = f"{src}.rep."
    seps = _rep_indices(keys, rep, ".conv1.weight")
    bns = _rep_indices(keys, rep, ".running_mean")
    units = [f"sepconv{i}" for i in range(block.n_units)]
    if len(seps) != len(units) + (block.tail is not None) or len(bns) != len(units):
        return []
    out = []
    for i, name in zip(seps, units + [block.tail]):
        out += sep_names(f"{port}.{name}", f"{rep}{i}")
    for i, u in zip(bns, range(block.n_units)):
        out += bn_names(f"{port}.bn{u}", f"{rep}{i}")
    if block.skip_conv is not None:
        out += conv_names(f"{port}.skip_conv", f"{src}.skip")
        out += bn_names(f"{port}.skip_bn", f"{src}.skipbn")
    return out


def pretrained_assignments(pretrain_dict: Dict[str, torch.Tensor], model: torch.nn.Module
                           ) -> Tuple[List[Tuple[str, str]], Dict[str, torch.Tensor]]:
    """The remapped source, ``xception_features.``-prefixed, and [(port
    state_dict key, its source key), ...] of every tensor that
    ``import_pretrained_xception`` lands from ``pretrain_dict`` into
    ``model`` (a ``DeepLabv3plus``): the key is in the source and the shapes
    agree."""
    src = {PREFIX + k: v for k, v in remap_pretrained_keys(pretrain_dict).items()}
    x = model.xception
    pairs = conv_names("xception.conv1", f"{PREFIX}conv1")
    pairs += conv_names("xception.conv2", f"{PREFIX}conv2")
    pairs += bn_names("xception.bn1", f"{PREFIX}bn1") + bn_names("xception.bn2", f"{PREFIX}bn2")
    for i in range(1, 21):
        pairs += _block_pairs(src, f"xception.block{i}", f"{PREFIX}block{i}",
                              getattr(x, f"block{i}"))
    for i in (3, 4, 5):
        pairs += sep_names(f"xception.conv{i}", f"{PREFIX}conv{i}")
        pairs += bn_names(f"xception.bn{i}", f"{PREFIX}bn{i}")
    sd = model.state_dict()
    return [(p, s) for p, s in pairs if s in src and src[s].shape == sd[p].shape], src


def import_pretrained_xception(pretrain_dict: Dict[str, torch.Tensor],
                               model: torch.nn.Module) -> int:
    """Fills ``model``'s backbone in place from a cadene ImageNet Xception
    state_dict (on any device); every other tensor keeps its value.
    Returns the number of tensors landed."""
    pairs, src = pretrained_assignments(pretrain_dict, model)
    sd = model.state_dict()
    with torch.no_grad():
        for p, s in pairs:
            sd[p].copy_(src[s])
    return len(pairs)


def convert_checkpoint(torch_path: str, out_path: str, optimizer: str = "AdamW",
                       start_lr: float = 1e-3, adam_eps: float = 1e-8,
                       weight_decay: float = 1e-6, pretrained_backbone: bool = False,
                       device="cuda") -> Dict:
    """A port checkpoint at ``out_path`` from ``torch_path``.  The model and
    optimizer are built as ``cli/train.py`` builds them (os=16, the deconv
    decoder, 16 input channels), from seed 333 as the JAX converter's.  With
    ``pretrained_backbone`` the input is a cadene Xception state_dict,
    imported into the backbone over that init, and the checkpoint is at step
    0 and epoch 0;
    otherwise it is a checkpoint in the reference's schema, restored and
    written back."""
    from ..ckpt.checkpoint import restore_checkpoint, save_checkpoint
    from ..models.deeplab import DeepLabv3plus
    from ..train.optim import build_optimizer
    from ..train.trainer import create_train_state

    device = resolve_device(device)
    model = DeepLabv3plus(n_classes=3, output_stride=16, device=device, seed=333)
    opt = build_optimizer(optimizer, model.parameters(), start_lr, eps=adam_eps,
                          weight_decay=weight_decay)
    state = create_train_state(model, opt)
    info = {"path": out_path}
    if pretrained_backbone:
        blob = torch.load(torch_path, map_location="cpu", weights_only=True)
        info["imported"] = import_pretrained_xception(blob, model)
    else:
        state, _ = restore_checkpoint(torch_path, state)
    info.update(step=int(state.step), epoch=int(state.epoch))
    save_checkpoint(out_path, state, state.epoch)
    return info


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Import a reference checkpoint or pretrained Xception weights")
    p.add_argument("--checkpoint", required=True,
                   help="reference .cpt ({step, epoch, model, optimizer}) or, with "
                        "--pretrained_backbone, a cadene Xception .pth")
    p.add_argument("--output", required=True, help="port checkpoint to write")
    p.add_argument("--optimizer", default="AdamW", choices=["Adam", "AdamW", "LAMB"])
    p.add_argument("--start_lr", type=float, default=1e-3)
    p.add_argument("--adam_eps", type=float, default=1e-8)
    p.add_argument("--weight_decay", type=float, default=1e-6)
    p.add_argument("--pretrained_backbone", action="store_true",
                   help="the input is cadene ImageNet Xception weights, not a "
                        "training checkpoint")
    p.add_argument("--device", default="cuda", help="device the model is built on")
    return p


def main(argv=None) -> Dict:
    args = build_parser().parse_args(argv)
    info = convert_checkpoint(
        args.checkpoint, args.output, optimizer=args.optimizer, start_lr=args.start_lr,
        adam_eps=args.adam_eps, weight_decay=args.weight_decay,
        pretrained_backbone=args.pretrained_backbone, device=args.device)
    print(info)
    return info


if __name__ == "__main__":
    main()
