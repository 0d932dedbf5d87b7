"""`chip_smoke.register_quality`, phase 19a's reading of the emotion-register
JSON, against the JAX package's own asserts
(``tests/test_emotion_register.py``), called on the same result: a bar is
broken exactly when JAX's test of it fails.  The cases are a card run's
readings (every bar met) and that run moved across each bar."""

import copy

import pytest

import chip_smoke
from tests import test_emotion_register as jax_bars

RUN = {
    "registers": {"happy": {"pred_f0_hz": 200.98, "synth_frames": 88},
                  "neutral": {"pred_f0_hz": 183.52, "synth_frames": 100},
                  "sad": {"pred_f0_hz": 169.03, "synth_frames": 109},
                  "angry": {"pred_f0_hz": 205.1, "synth_frames": 90}},
    "per_emotion_val": {"angry": {"n": 5, "dur_err_pct": 6.77},
                        "happy": {"n": 2, "dur_err_pct": 9.12},
                        "neutral": {"n": 4, "dur_err_pct": 3.7},
                        "sad": {"n": 5, "dur_err_pct": 4.97}},
    "vad_proj_abs_mean": 0.0213,
}

# JAX's test functions and the bars each asserts
JAX_TESTS = {"test_f0_register_ordering": ("f0_order",),
             "test_duration_register_ordering": ("frames_order",),
             "test_vad_projection_learned": ("vad_proj",),
             "test_per_emotion_duration_target": ("emotions", "durerr_aggregate",
                                                  "durerr_per_emotion")}


def _moved(path, value):
    res = copy.deepcopy(RUN)
    *keys, last = path
    d = res
    for k in keys:
        d = d[k]
    if value is None:
        del d[last]
    else:
        d[last] = value
    return res


CASES = {
    "met": (RUN, []),
    # happy's reading in one card run of the recipe: 16.66 % at n=2
    "happy_over_15": (_moved(("per_emotion_val", "happy", "dur_err_pct"), 16.66),
                      ["durerr_per_emotion"]),
    # every emotion under 15 % and 11.38 % in aggregate
    "aggregate_over_10": (_moved(("per_emotion_val",),
                                 {e: {"n": row["n"], "dur_err_pct": 14.9 if e in ("angry", "sad")
                                      else row["dur_err_pct"]}
                                  for e, row in RUN["per_emotion_val"].items()}),
                          ["durerr_aggregate"]),
    "f0_tie": (_moved(("registers", "neutral", "pred_f0_hz"), 169.03), ["f0_order"]),
    "frames_tie_allowed": (_moved(("registers", "neutral", "synth_frames"), 88), []),
    "frames_sad_not_longest": (_moved(("registers", "sad", "synth_frames"), 100),
                               ["frames_order"]),
    "vad_unlearned": (_moved(("vad_proj_abs_mean",), 1e-3), ["vad_proj"]),
    "emotion_missing": (_moved(("per_emotion_val", "angry"), None), ["emotions"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_register_bars_match_jax_asserts(case):
    res, broken = CASES[case]
    q = chip_smoke.register_quality(res)
    assert q["broken"] == broken
    for name, bars in JAX_TESTS.items():
        try:
            getattr(jax_bars, name)(res)
            jax_met = True
        except AssertionError:
            jax_met = False
        assert jax_met == (not set(bars) & set(q["broken"])), name


def test_gating_bars_are_register_bars():
    assert set(chip_smoke.REGISTER_GATING_BARS) <= set(chip_smoke.REGISTER_BARS)
    assert "durerr_per_emotion" not in chip_smoke.REGISTER_GATING_BARS
