"""One update of the port's ``make_train_step`` against the reference's,
for every arch's SMOKE config in f32, with AdamW and Adafactor, and with
microbatches 1 and 2.

Bands: the loss and grad norm within ``_torch_lm.BAND["f32"]``; every
param within 0.05 x lr of the reference's after the update, except where
the sign of the update is not defined by the gradients' band. The first
update of AdamW is close to lr x sign(g) (m / sqrt(v) = g / |g| at step
1), and Adafactor's first momentum has the sign of g too, so an element
whose gradient lies within the gradient band of 0 (its first moment
within ``BAND["f32"]`` of its leaf's max |m|) may step the other way: it
is held within 2.1 x lr. The update is held to the step's size, lr,
rather than to the params' scale. With microbatches the reference rounds
the gradient sum to bf16, and so does the port.
"""

import numpy as np
import pytest

from _torch_lm import BAND, batches, f32, leaves, pair
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch.configs import ARCHS
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

LR = 1e-3
STEP_BAND = 0.05


def _configs(kind, mb):
    return (ref_ts.TrainConfig(opt=ref_opt.OptConfig(kind=kind, lr=LR,
                                                     warmup_steps=2),
                               loss_chunk=8, microbatches=mb),
            ts.TrainConfig(opt=opt.OptConfig(kind=kind, lr=LR,
                                             warmup_steps=2),
                           loss_chunk=8, microbatches=mb))


def _one_update(arch, kind, mb, b=2):
    rm, rp, pm, pp = pair(arch, "f32")
    rb, pb = batches(rm.cfg, b=b)
    rt, pt = _configs(kind, mb)
    rp1, rs1, rmet = ref_ts.make_train_step(rm.cfg, rt)(
        rp, ref_opt.init(rp, rt.opt), rb)
    pp1, ps1, pmet = ts.make_train_step(pm.cfg, pt)(
        pp, opt.init(pp, pt.opt), pb)
    for key in ("loss", "grad_norm"):
        want = float(rmet[key])
        assert abs(float(pmet[key]) - want) <= BAND["f32"] * abs(want), key
    got, want, m = leaves(pp1), leaves(rp1), leaves(rs1["m"])
    assert sorted(got) == sorted(want)
    for k in want:
        err = np.abs(f32(got[k]) - f32(want[k]))
        mk = np.abs(f32(m[k]))
        signed = mk > BAND["f32"] * mk.max()
        assert err[signed].max(initial=0) <= STEP_BAND * LR, \
            (arch, kind, k, err[signed].max() / LR)
        assert err.max() <= 2.1 * LR, (arch, kind, k, err.max() / LR)
    assert int(ps1["step"]) == int(rs1["step"]) == 1


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_update_matches_reference(arch, kind):
    _one_update(arch, kind, 1)


@pytest.mark.parametrize("arch,kind", [("qwen2-0.5b", "adamw"),
                                       ("dbrx-132b", "adafactor"),
                                       ("whisper-base", "adamw")])
def test_microbatched_update_matches_reference(arch, kind):
    """Two microbatches of 2 rows: gradients summed in f32, divided by 2
    and cast to bf16 on both sides."""
    _one_update(arch, kind, 2, b=4)
