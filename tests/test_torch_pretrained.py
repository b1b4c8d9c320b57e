"""The pretrained-Xception import and the checkpoint converter
(``deepcam_tpu_torch/tools/import_torch_checkpoint.py``) against the JAX
package's importer.  No weights are downloaded: the source dicts are made
here from a seed, in the cadene ImageNet Xception's layout
(``cadene_xception_shapes``) or as the inverse of the remap from the port's
own backbone.  The JAX side needs no model init: its variables come from
the port's through the weight bridge."""

import numpy as np
import pytest
import torch

from deepcam_tpu_torch.ckpt.checkpoint import restore_checkpoint
from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
from deepcam_tpu_torch.tools import import_torch_checkpoint as imp
from deepcam_tpu_torch.tools.ref_names import xception_names
from deepcam_tpu_torch.tools.weights import state_dict_to_jax
from deepcam_tpu_torch.train.optim import build_optimizer
from deepcam_tpu_torch.train.trainer import create_train_state
from tests.torch_port_ref import flatten
from tests.torch_port_ref import release_memory  # noqa: F401  (autouse)

VARIANTS = [dict(output_stride=16), dict(output_stride=8, decoder="interpolation")]
# what a cadene file lands in the port's backbone (and JAX's): conv2, bn1,
# bn2; blocks 4-10 and 12 (from cadene's block11), 18 tensors each; conv3,
# bn3, bn4 (cadene's bn3), conv5 (cadene's conv4), bn5
CADENE_LANDED = 1 + 8 + 8 * 18 + 2 + 4 + 4 + 2 + 4


def cadene_dict(seed):
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=gen)
            for k, s in imp.cadene_xception_shapes().items()}


def _variables(model):
    params, stats = state_dict_to_jax(model, model.state_dict())
    return {"params": params, "batch_stats": stats}


def test_remap_matches_jax():
    """The key remap on a dict of every renamed prefix, with 2-D and 4-D
    pointwise weights: the same keys and values as JAX's."""
    from deepcam_tpu.tools.import_torch_checkpoint import remap_pretrained_keys as jax_remap

    gen = torch.Generator().manual_seed(3)
    src = {k: torch.randn(s, generator=gen) for k, s in {
        "block12.rep.1.pointwise.weight": (6, 4), "block11.rep.4.pointwise.weight": (4, 4, 1, 1),
        "block11.rep.5.running_mean": (4,), "block1.rep.0.conv1.weight": (4, 1, 3, 3),
        "block10.skip.weight": (4, 4, 1, 1), "conv3.pointwise.weight": (6, 4),
        "conv3.conv1.weight": (4, 1, 3, 3), "bn3.weight": (6,), "conv4.pointwise.weight": (8, 6),
        "bn4.running_var": (8,), "conv1.weight": (32, 3, 3, 3), "fc.bias": (10,)}.items()}
    got, want = imp.remap_pretrained_keys(src), jax_remap(src)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    assert got["block20.rep.1.pointwise.weight"].shape == (6, 4, 1, 1)
    assert got["bn4.weight"] is got["bn3.weight"]


@pytest.mark.parametrize("variant", VARIANTS, ids=["os16", "os8_interpolation"])
def test_cadene_import_lands_jaxs_slots(variant):
    """A cadene-shaped dict lands exactly the tensors JAX's importer lands,
    with its count: blocks 1-3 and 20 land nothing (their sources have two
    separable convs where the port has three with the tail), the 3-channel
    conv1 keeps the init, bn4 takes cadene's bn3.  Every tensor of the port
    afterwards equals JAX's result, landed or not."""
    from deepcam_tpu.tools.import_torch_checkpoint import import_pretrained_xception as jax_import

    src = cadene_dict(7)
    model = DeepLabv3plus(3, device="cpu", seed=1, **variant)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    want, jax_n = jax_import(src, _variables(model))
    n = imp.import_pretrained_xception(src, model)
    assert n == jax_n == CADENE_LANDED
    got, want = flatten(_variables(model)), flatten(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    sd = model.state_dict()
    landed = {p for p, _ in imp.pretrained_assignments(src, model)[0]}
    assert len(landed) == n
    assert not any(p.startswith(("xception.block1.", "xception.block2.", "xception.block3.",
                                 "xception.block11.", "xception.block20.", "xception.conv1."))
                   for p in landed)
    torch.testing.assert_close(sd["xception.bn4.weight"], src["bn3.weight"], rtol=0, atol=0)
    torch.testing.assert_close(sd["xception.block12.sepconv2.pointwise.weight"][:, :, 0, 0],
                               src["block11.rep.7.pointwise.weight"], rtol=0, atol=0)
    for k, v in sd.items():
        if k not in landed:
            assert torch.equal(v, before[k]), k


def test_inverse_remap_lands_every_reachable_slot():
    """A source made from the port's own os=8 backbone as the inverse of the
    remap (block20→block12, block12→block11, conv5→conv4, bn5→bn4, the
    reference's rep indices) lands every backbone tensor that a remapped
    key can reach, each with its own value: all but block11 and conv4
    (renamed away by the remap) and bn4, which takes bn3's.  JAX's importer
    lands the same."""
    from deepcam_tpu.tools.import_torch_checkpoint import import_pretrained_xception as jax_import

    ref = DeepLabv3plus(3, device="cpu", seed=2, output_stride=8, decoder="interpolation")
    inverse = {"block20": "block12", "block12": "block11", "conv5": "conv4", "bn5": "bn4"}
    unreachable = ("block11.", "conv4.", "bn4.")
    sd_ref, src = ref.state_dict(), {}
    for port, name in xception_names(ref.xception):
        key = name[len(imp.PREFIX):]
        if key.startswith(unreachable):
            continue
        head = key.split(".")[0]
        src[key.replace(head, inverse.get(head, head), 1)] = sd_ref[port].clone()
    model = DeepLabv3plus(3, device="cpu", seed=3, output_stride=8, decoder="interpolation")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    want, jax_n = jax_import(src, _variables(model))
    n = imp.import_pretrained_xception(src, model)
    backbone = [k for k in model.state_dict() if k.startswith("xception.")]
    skipped = [k for k in backbone if k.startswith(("xception.block11.", "xception.conv4."))]
    assert n == jax_n == len(backbone) - len(skipped)
    sd = model.state_dict()
    for k in backbone:
        if k in skipped:
            expect = before[k]
        elif k.startswith("xception.bn4."):
            expect = sd_ref[k.replace("bn4", "bn3")]
        else:
            expect = sd_ref[k]
        assert torch.equal(sd[k], expect), k
    got, want = flatten(_variables(model)), flatten(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_converter_writes_a_restorable_checkpoint(tmp_path):
    """``--pretrained_backbone``: a cadene file becomes a step-0 port
    checkpoint that ``restore_checkpoint`` takes, with the backbone
    imported over the seeded init.  Without the flag: a checkpoint in the
    reference's schema (no ``module.`` prefix, the BN counters) is restored
    and written back in the port's, the same tensors."""
    pth = str(tmp_path / "xception.pth")
    src = cadene_dict(9)
    torch.save(src, pth)
    out = str(tmp_path / "init.cpt")
    info = imp.main(["--pretrained_backbone", "--checkpoint", pth, "--output", out,
                     "--optimizer", "LAMB", "--device", "cpu"])
    assert info == {"path": out, "imported": CADENE_LANDED, "step": 0, "epoch": 0}

    model = DeepLabv3plus(3, device="cpu", seed=5)
    blank = create_train_state(model, build_optimizer("LAMB", model.parameters(), 1e-3))
    state, epoch = restore_checkpoint(out, blank)
    assert (state.step, epoch) == (0, 0)
    want = DeepLabv3plus(3, device="cpu", seed=333)
    imp.import_pretrained_xception(src, want)
    for k, v in want.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k

    blob = torch.load(out, weights_only=True)
    blob["model"] = {k[len("module."):]: v for k, v in blob["model"].items()}
    blob["model"].update({k.rsplit(".", 1)[0] + ".num_batches_tracked": torch.tensor(0)
                          for k in blob["model"] if k.endswith(".running_mean")})
    ref = str(tmp_path / "reference.cpt")
    torch.save(blob, ref)
    again = str(tmp_path / "again.cpt")
    assert imp.convert_checkpoint(ref, again, device="cpu") == {
        "path": again, "step": 0, "epoch": 0}
    for v in state.model.state_dict().values():
        v.zero_()
    state, _ = restore_checkpoint(again, state)
    for k, v in want.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
