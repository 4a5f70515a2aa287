"""``chip_smoke.f32_ring_reading``, the reading of a mesh's f32 steps
through the real ring, on losses read on four H100s: a mesh's three f32
steps through the ring beside one card's f32 steps of the same config
and batch through the kernels, with plain f32 attention and with plain
attention in f64.

Every sound mesh run passes; a ring whose ``merge`` rounds each block's
lse to bf16 fails at sp 2 and at sp 4. At sp 4 that fault shows only at
step 2 (6.9e-5 from the kernel path, inside ``f32_steps_rule``), which
is what RING_F32_RTOL at the first RING_F32_STEPS steps is there for;
sound sp 2 at full depth reads 2.06e-4 at step 3, within the rule, where
one card's own f32 paths spread as far.
"""
import pytest

import chip_smoke

#: One card's f32 steps by config: through the kernels, plain f32, f64.
ONE_CARD = {
    "lm_sp2": ([10.893924713134766, 9.996625900268555, 9.976150512695312],
               [10.89392375946045, 9.99666976928711, 9.977405548095703],
               [10.893924713134766, 9.996684074401855, 9.975110054016113]),
    "lm_sp4": ([10.89990234375, 9.11086654663086, 14.307734489440918],
               [10.899903297424316, 9.110869407653809, 14.307641983032227],
               [10.899903297424316, 9.110895156860352, 14.307676315307617]),
    "lm_dp2sp2": ([10.901865005493164, 9.229818344116211, 13.348150253295898],
                  [10.901865005493164, 9.229822158813477, 13.34817123413086],
                  [10.901865005493164, 9.229816436767578,
                   13.348068237304688]),
    "lm_fsdp_tp": ([10.886629104614258, 10.471542358398438,
                    11.922489166259766],
                   [10.886629104614258, 10.471443176269531,
                    11.920839309692383],
                   [10.886629104614258, 10.471561431884766, 11.922119140625]),
    "moe_ep2": ([10.914642333984375, 10.478983879089355, 11.238415718078613],
                [10.914642333984375, 10.478991508483887, 11.239029884338379],
                [10.914642333984375, 10.478984832763672, 11.2387056350708]),
    "moe_2layer": ([10.902294158935547, 9.618476867675781, 9.457588195800781],
                   [10.902294158935547, 9.618480682373047, 9.457555770874023],
                   [10.902294158935547, 9.618477821350098,
                    9.457552909851074]),
}

#: Each mesh run's f32 ring losses, its one-card config, and whether the
#: reading must pass.
RUNS = {
    "sp2": ("lm_sp2", [10.893924713134766, 9.996561050415039,
                       9.978205680847168], True),
    "sp4": ("lm_sp4", [10.89990234375, 9.110916137695312,
                       14.307686805725098], True),
    "dp2sp2": ("lm_dp2sp2", [10.901865005493164, 9.229819297790527,
                             13.348307609558105], True),
    "fsdp2": ("lm_fsdp_tp", [10.886629104614258, 10.471545219421387,
                             11.922330856323242], True),
    "tp2": ("lm_fsdp_tp", [10.886629104614258, 10.471563339233398,
                           11.921908378601074], True),
    "fsdp2tp2": ("lm_fsdp_tp", [10.886629104614258, 10.471562385559082,
                                11.921820640563965], True),
    "sp2tp2": ("lm_fsdp_tp", [10.886629104614258, 10.47157096862793,
                              11.921570777893066], True),
    "ep2": ("moe_ep2", [10.914642333984375, 10.478986740112305,
                        11.238733291625977], True),
    "ep2sp2": ("moe_2layer", [10.902295112609863, 9.618476867675781,
                              9.457590103149414], True),
    "dp2ep2": ("moe_2layer", [10.902294158935547, 9.618475914001465,
                              9.45760726928711], True),
    "ep2tp2": ("moe_2layer", [10.902294158935547, 9.618484497070312,
                              9.457521438598633], True),
    "sp2_lse_bf16": ("lm_sp2", [10.893926620483398, 9.997873306274414,
                                10.139734268188477], False),
    "sp4_lse_bf16": ("lm_sp4", [10.899927139282227, 9.110239028930664,
                                14.308283805847168], False),
}


def _reading(losses, config, sp=2):
    kernels, plain, f64 = ONE_CARD[config]
    one = {"f32_kernels": {"losses": kernels}, "f32": {"losses": plain},
           "f64": {"losses": f64}}
    layers = 3
    ranks = [{"rank": i, "coordinate": {"sp": i}, "f32_ring_losses": losses,
              "f32_ring_seconds": 1.0,
              "f32_ring_launches": chip_smoke.causal_only(
                  flash_attn_fwd_f32=2 * layers, flash_attn_bwd_f32=layers,
                  flash_attn_fwd_f32_non_causal=2 * layers * i,
                  flash_attn_bwd_f32_non_causal=layers * i)}
             for i in range(sp)]
    return chip_smoke.f32_ring_reading(ranks, one, layers)


@pytest.mark.parametrize("run", RUNS)
def test_f32_ring_reading_on_four_card_losses(run):
    config, losses, ok = RUNS[run]
    got = _reading(losses, config)
    assert got["ok"] is ok, got
    assert got["bound"] == [chip_smoke.RING_F32_RTOL] * \
        chip_smoke.RING_F32_STEPS + [None]


def test_f32_ring_reading_power_at_steps_one_and_two():
    """The sp 4 fault passes ``f32_steps_rule`` at every step and the old
    1e-4 at every step; only the bound at steps 1-2 rejects it, and a
    sound run's largest reading there keeps a margin of 3x under it."""
    config, losses, _ = RUNS["sp4_lse_bf16"]
    got = _reading(losses, config)
    assert got["steps_rule"]["ok"] and max(got["rel"]) <= 1e-4
    assert got["rel"][1] > 3 * chip_smoke.RING_F32_RTOL
    sound = max(r for name, (config, losses, ok) in RUNS.items() if ok
                for r in _reading(losses, config)["rel"][
                    :chip_smoke.RING_F32_STEPS])
    assert 3 * sound <= chip_smoke.RING_F32_RTOL


def test_f32_ring_reading_needs_the_same_losses_on_every_rank():
    config, losses, _ = RUNS["sp4"]
    got = _reading(losses, config, sp=4)
    assert got["ok"]
    kernels, plain, f64 = ONE_CARD[config]
    one = {"f32_kernels": {"losses": kernels}, "f32": {"losses": plain},
           "f64": {"losses": f64}}
    ranks = [{"rank": i, "coordinate": {"sp": i},
              "f32_ring_losses": losses if i else kernels,
              "f32_ring_seconds": 1.0,
              "f32_ring_launches": chip_smoke.causal_only(
                  flash_attn_fwd_f32=6, flash_attn_bwd_f32=3,
                  flash_attn_fwd_f32_non_causal=6 * i,
                  flash_attn_bwd_f32_non_causal=3 * i)} for i in range(2)]
    assert not chip_smoke.f32_ring_reading(ranks, one, 3)["ok"]
