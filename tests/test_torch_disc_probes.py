"""The discriminator probes of the port (``spev_tpu_torch.diag.disc_profile``,
``disc_roofline``, ``disc_bf16_probe`` and their ``tools/torch_disc_*.py``
runners) against the JAX package's tools, on the CPU.

- **The counts.** `mpd_cost` and `msd_cost` equal, FLOPs and bytes
  exactly, the convolutions the port's `Discriminators` really runs (every
  ``aten.convolution`` caught by a dispatch mode on the meta device: the
  sub-discriminators call ``F.conv*`` on their weights, so no module hook
  sees them) at three (B, T), fp32 and bf16.  Against ``tools/
  disc_roofline.py`` (loaded from its path) at B=16, T=8192: MPD FLOPs
  exactly, MSD FLOPs equal to JAX's count at the port's pooled length; the
  bytes where the pooled lengths agree are JAX's plus what JAX leaves out:
  the intermediate inputs' reads, the MPD's pad, the post convs' weights
  and every bias (F7).
- **The profile's function.** `profile_loss` of each sub-discriminator (the
  port's inputs from `sub_discriminators`) against the JAX tool's ``fwd`` on
  the same weights (a numpy-seeded JAX tree carried across by
  `discriminators_state_dict_from_tree`): within 1e-5 relative in fp32, the
  parameter gradients within 1e-5 of ``jax.grad(fwd)``'s max |g|; in bf16
  (weights and wav cast, as both tools cast them) the loss within 2e-2
  relative of JAX's fp32 ``fwd``.
- **The probe** at JAX's tiny generator (``TINY`` of
  ``tests/test_torch_vocoder_training.py``, periods (2,), one scale with
  its channels cut, B=2, 16 frames, 3 steps) from JAX's initial state: the
  pool bit-equal to the JAX tool's, the fp32 step 1 within 1e-5 relative of
  JAX's fused step (unfolded: JAX's folded one takes ~40 s to compile on the
  CPU), the bf16 step 1 within JAX's 8 % bar, the summary's keys the JAX
  tool's.
- **The runners' flags**: the JAX tools' flags and defaults (read with
  ``ast``) plus ``--device``, ``--out`` and the probe's ``--seed`` only (the
  roofline's reads files and takes no ``--device``); the roofline's peaks
  default to the H100's per row (the JAX tool's are a TPU's).  Each runner
  from its arguments to its lines, the profile and the probe stubbed.
"""

import ast
import concurrent.futures
import contextlib
import importlib.util
import json
import math
import pathlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from spev_tpu.config import AudioConfig as JAudioConfig
from spev_tpu.models import hifigan_disc as jdisc
from spev_tpu.models.hifigan import HiFiGANConfig as JaxCfg
from spev_tpu.train import vocoder_trainer as jvt
from spev_tpu_torch.diag import disc_bf16_probe as probe
from spev_tpu_torch.diag import disc_profile as prof
from spev_tpu_torch.diag import disc_roofline as roof
from spev_tpu_torch.models import hifigan_disc
from spev_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from spev_tpu_torch.models.hifigan_disc import MPD_PERIODS, Discriminators
from spev_tpu_torch.train import vocoder_trainer as vt
from spev_tpu_torch.utils.params import (discriminators_state_dict_from_tree,
                                        state_dict_from_tree)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY_KW = dict(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
               upsample_initial_channel=16, resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 2),), num_mels=80)
NAMES = [f"mpd_p{p}" for p in MPD_PERIODS] + [f"msd_s{s}" for s in range(3)]
N_STACK = {"mpd": 4, "msd": 7}  # the strided stack's convs, before the post convs
PROBE = dict(steps=3, batch_size=2, segment_frames=16)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the six-worker run shares the machine's cores
    yield
    torch.set_num_threads(n)


def _load(rel):
    spec = importlib.util.spec_from_file_location(pathlib.Path(rel).stem, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the JAX tool binds the spec at import: import it before `jax_side` patches it
JAX_ROOFLINE = _load("tools/disc_roofline.py")


# -- the JAX side, shared by the module -------------------------------------------------


def _jax_loss(outs):
    """The JAX tool's ``fwd`` body (``tools/tpu_disc_profile.py:88-91,105-108``)."""
    logits, feats = outs
    return (jnp.mean(logits.astype(jnp.float32) ** 2)
            + sum(jnp.mean(jnp.abs(f).astype(jnp.float32)) for f in feats))


def _jax_subs(params, wav):
    """The JAX tool's sub-discriminator loop: (name, apply(params), params, input)."""
    for p, period in zip(params["mpd"], MPD_PERIODS):
        yield f"mpd_p{period}", lambda prm, w, _p=period: jdisc.apply_period_disc(
            prm, w, period=_p), p, wav
    x = wav
    for s, p in enumerate(params["msd"]):
        if s > 0:
            x = jdisc._avg_pool(x, 4)
        yield f"msd_s{s}", jdisc.apply_scale_disc, p, x


def _jax_tool_pool(B, T, audio=JAudioConfig()):
    """``tools/disc_bf16_probe.py:61-71`` as the tool writes it."""
    rng = np.random.default_rng(0)
    return [
        (jnp.asarray(rng.normal(-4, 2, (B, T, audio.n_mels)), jnp.float32),
         jnp.asarray(0.2 * np.sin(
             2 * np.pi * (120 + 40 * k) / audio.sample_rate
             * np.arange(B * T * audio.hop_length).reshape(B, -1))
             + 0.02 * rng.normal(0, 1, (B, T * audio.hop_length)),
             jnp.float32))
        for k in range(4)
    ]


# The probe's MSD at narrow widths (the convolutions' channels cut, kernels,
# strides and pads kept; its last width stays JAX's hard-coded 1024 into the
# post conv): a step on the CPU then takes a third of the full width's.
PROBE_MSD = ((1, 16, 15, 1, 1, 7), (16, 16, 41, 2, 4, 20), (16, 32, 41, 2, 16, 20),
             (32, 64, 41, 4, 16, 20), (64, 64, 41, 4, 16, 20), (64, 64, 41, 1, 16, 20),
             (64, 1024, 5, 1, 1, 2))


@contextlib.contextmanager
def _probe_msd(module):
    mp = pytest.MonkeyPatch()
    mp.setattr(module, "_MSD_SPEC", PROBE_MSD)
    try:
        yield
    finally:
        mp.undo()


@pytest.fixture(scope="module", autouse=True)
def jax_side():
    """Everything JAX computes for the module, in a thread while the port's
    tests run, as futures: ``init``, JAX's initial state for the probe (TINY,
    periods (2,), one scale at `PROBE_MSD`) and its fused step traced on the
    pool's step-1 batch; ``step1``, that step compiled and taken; ``profile``,
    numpy-seeded full-width discriminator weights in JAX's tree, a (2, 300)
    wav, and each sub-discriminator's loss and gradients in fp32 (one jit).
    One thread runs them in that order, so the patched spec never meets
    another JAX trace."""
    jcfg = JaxCfg(**TINY_KW)
    key = jax.random.PRNGKey(0)
    jpool = _jax_tool_pool(PROBE["batch_size"], PROBE["segment_frames"])

    def init():
        with _probe_msd(jdisc):
            fn = jax.jit(lambda k: jvt.init_vocoder_train_state(k, jcfg, periods=(2,),
                                                                n_scales=1))
            # run once: compiled without LLVM's optimisations, most of its compile time
            state = jax.tree.map(np.asarray, fn.lower(key).compile(
                {"xla_backend_optimization_level": 0})(key))
            jstate = jax.tree.map(jnp.asarray, state)
            step = jvt.make_vocoder_train_step(jcfg, JAudioConfig(), periods=(2,), fused=True)
            return state, jstate, step.dg_step.lower(jstate, *jpool[1])

    def step1():
        _, jstate, lowered = jax_init.result()
        _, m = lowered.compile()(jstate, *jpool[1])
        return {k: float(v) for k, v in m.items()}

    def profile():
        shapes = jax.eval_shape(jdisc.init_discriminators, key)
        rng = np.random.default_rng(0)
        tree = jax.tree.map(lambda s: (rng.random(s.shape, np.float32) - 0.5) / 10, shapes)
        wav = np.random.default_rng(1).normal(0, 0.1, (2, 300)).astype(np.float32)

        def run(params, w):
            return {name: jax.value_and_grad(
                        lambda prm, x=x, apply=apply: _jax_loss(apply(prm, x)))(p)
                    for name, apply, p, x in _jax_subs(params, w)}

        out = jax.jit(run)(jax.tree.map(jnp.asarray, tree), jnp.asarray(wav))
        return tree, wav, {name: (float(v), jax.tree.map(np.asarray, g))
                           for name, (v, g) in out.items()}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_init = pool.submit(init)
        yield SimpleNamespace(jpool=jpool, init=jax_init, step1=pool.submit(step1),
                              profile=pool.submit(profile))


# -- the counts ----------------------------------------------------------------------


class _Convs(TorchDispatchMode):
    """Every convolution's (input, weight, bias, output) shapes and element size."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.convolution.default:
            x, w, b = args[0], args[1], args[2]
            self.calls.append({"in": x.numel(), "w": w.numel(), "b": b.numel(),
                               "out": out.numel(), "k": math.prod(w.shape[2:]),
                               "cin_g": w.shape[1], "bp": x.element_size()})
        return out


@pytest.fixture(scope="module")
def conv_shapes():
    """{(B, T, dtype): {sub-discriminator: [its convolutions]}} on the meta device."""
    with torch.device("meta"):
        disc = Discriminators()
    out = {}
    for B, T, dtype in ((2, 1031, "f32"), (3, 700, "bf16"), (16, 8192, "f32")):
        wav = torch.empty(B, T, device="meta").to(prof.DTYPES[dtype] or torch.float32)
        got = {}
        for name, sub, x in prof.sub_discriminators(disc, wav):
            with torch.no_grad(), _Convs() as mode:
                sub(x, prof.DTYPES[dtype])
            got[name] = mode.calls
        out[(B, T, dtype)] = got
    return out


def _flops(convs):
    return sum(2 * c["out"] * c["cin_g"] * c["k"] for c in convs)


def test_counts_equal_the_convolutions(conv_shapes):
    for (B, T, dtype), subs in conv_shapes.items():
        assert list(subs) == NAMES
        for name, convs in subs.items():
            assert len(convs) == N_STACK[name[:3]] + (2 if name.startswith("mpd") else 1)
            assert {c["bp"] for c in convs} == {roof.BYTES_PER[dtype]}
            bytes_ = sum((c["in"] + c["out"] + c["w"] + c["b"]) * c["bp"] for c in convs)
            assert roof.cost(name, B, T, dtype) == (_flops(convs), bytes_), (B, T, dtype, name)


def test_counts_against_the_jax_tool(conv_shapes):
    jax_tool = JAX_ROOFLINE
    B, T, bp = 16, 8192, 4
    subs = conv_shapes[(B, T, "f32")]
    total = 0
    for name, convs in subs.items():
        kind, n = name.split("_")
        n = int(n[1:])
        jf, jb = (jax_tool.mpd_cost if kind == "mpd" else jax_tool.msd_cost)(n, B, T, bp)
        pf, pb = roof.cost(name, B, T, "f32")
        total += jf
        if kind == "msd" and n > 0:
            # the pooled length alone differs (the port's T//2 + 1 a step, JAX's T // 2**s):
            # JAX's count at the port's length is the port's, here 0.88 % / 1.77 % over JAX's
            L = roof.msd_length(n, T)
            assert L > T // 2 ** n and pf > jf, name
            assert jax_tool.msd_cost(n, B, 2 ** n * L, bp)[0] == pf, name
            continue
        assert pf == jf, name
        stack = convs[:N_STACK[kind]]
        # JAX counts the stack's first input (unpadded), every output, the stack's weights
        assert jb == (B * T + sum(c["out"] for c in convs) + sum(c["w"] for c in stack)) * bp
        intermediate = sum(c["in"] for c in convs[1:]) * bp
        pad = (convs[0]["in"] - B * T) * bp
        left_out = (sum(c["w"] for c in convs[N_STACK[kind]:]) + sum(c["b"] for c in convs)) * bp
        assert pb == jb + intermediate + pad + left_out, name
        assert intermediate > 0 and left_out > 0 and pad >= 0
    # JAX's count: 276.2 GFLOP over the eight forwards at B=16, T=8192
    assert abs(total / 1e9 - 276.2) < 0.1


def test_roofline_shares_and_table():
    rows = [{"disc": n, "fwd_ms": 2.0, "fwd_bwd_ms": 3.0, "precision": p, "dtype": d}
            for p, d in (("high", "f32"), ("default", "bf16")) for n in NAMES]
    entries = roof.roofline(rows + [{"total_fwd_ms": 8.0}], 16, 8192)
    assert len(entries) == 16
    for e in entries:
        flops, by = roof.cost(e["disc"], 16, 8192, e["dtype"])
        peak = roof.PEAK_TFLOPS[(e["precision"], e["dtype"])]
        assert e["share"] == pytest.approx(max(flops / 2e9 / peak, by / 2e6 / roof.HBM_GBS))
        assert e["bound_ms"] == pytest.approx(e["share"] * 2.0)
    table = roof.roofline_table(rows, 16, 8192).splitlines()
    assert len(table) == 2 + len(NAMES) + 2 and "f32 high fwd ms" in table[0]
    assert table[-1] == "total fwd+bwd (bf16 default): 24.00 ms"
    # on the card the rates are taken on the CUDA graph's device time
    graphed = [dict(r, fwd_ms=9.0, fwd_graph_ms=2.0, fwd_bwd_graph_ms=2.5) for r in rows]
    assert [e["share"] for e in roof.roofline(graphed, 16, 8192)] == [
        e["share"] for e in entries]
    assert roof.roofline_table(graphed, 16, 8192).splitlines()[-1] == (
        "total fwd+bwd (bf16 default): 24.00 ms, 20.00 ms on the device")
    # the peaks: 67 TFLOP/s fp32 at 'high', 495 TF32 at 'default', 989 bf16; 3350 GB/s
    assert roof.PEAK_TFLOPS[("default", "f32")] == 495.0 and roof.HBM_GBS == 3350.0
    fast = dict(rows[0], fwd_ms=1e-4)
    with pytest.raises(ValueError, match="count or the time is wrong"):
        roof.roofline([fast], 16, 8192)
    with pytest.raises(ValueError, match="finite and positive"):
        roof.roofline([dict(rows[0], fwd_bwd_ms=float("nan"))], 16, 8192)
    with pytest.raises(ValueError, match="finite and positive"):
        roof.roofline([dict(rows[0], fwd_graph_ms=0.0)], 16, 8192)
    # --peak_tflops / --hbm_gbs override every row's peak
    over = roof.roofline(rows[:1], 16, 8192, peak_tflops=1000.0, hbm_gbs=1000.0)[0]
    assert over["peak_tflops"] == over["hbm_gbs"] == 1000.0


# -- the profile on the CPU ------------------------------------------------------------


def test_time_sub_discriminators_on_the_cpu(monkeypatch):
    """The rows, the totals row and the TF32 flags after it, on narrow
    discriminators (the widths are the counts' and the loss's business)."""
    monkeypatch.setattr(hifigan_disc, "_MPD_CHANNELS", (4, 8, 8, 8))
    monkeypatch.setattr(hifigan_disc, "_MSD_SPEC", tuple(
        (min(i, 8) if i > 1 else 1, min(o, 8), k, s, 1, p)
        for i, o, k, s, g, p in hifigan_disc._MSD_SPEC))
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    rows = prof.time_sub_discriminators(2, 512, 1, precision="default", dtype="bf16",
                                        device="cpu")
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags
    assert [r["disc"] for r in rows[:-1]] == NAMES
    for r in rows[:-1]:
        assert set(r) == {"disc", "fwd_ms", "fwd_bwd_ms", "precision", "dtype", "device",
                          "fwd_host_ms", "fwd_bwd_host_ms", "fwd_graph_ms", "fwd_bwd_graph_ms"}
        assert (r["fwd_host_ms"], r["fwd_bwd_host_ms"]) == (r["fwd_ms"], r["fwd_bwd_ms"])
        assert r["fwd_graph_ms"] is None and r["fwd_bwd_graph_ms"] is None
        assert r["device"] == "cpu" and r["fwd_ms"] > 0 and r["fwd_bwd_ms"] > 0
        assert (r["precision"], r["dtype"]) == ("default", "bf16")
    totals = rows[-1]
    assert totals["total_fwd_ms"] == pytest.approx(sum(r["fwd_ms"] for r in rows[:-1]))
    assert {k: totals[k] for k in ("batch", "segment", "device", "card")} == {
        "batch": 2, "segment": 512, "device": "cpu", "card": None}
    with pytest.raises(ValueError, match="precision"):
        prof.time_sub_discriminators(precision="highest", device="cpu")


@pytest.mark.parametrize("entry", ["time_sub_discriminators", "bf16_probe"])
def test_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    fn = getattr(prof if entry.startswith("time") else probe, entry)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()


# -- the runners -----------------------------------------------------------------------


RUNNERS = {"tpu_disc_profile.py": ("torch_disc_profile.py", {"--device", "--out"}),
           "disc_roofline.py": ("torch_disc_roofline.py", {"--out"}),
           "disc_bf16_probe.py": ("torch_disc_bf16_probe.py", {"--device", "--out", "--seed"})}
# the JAX roofline's defaults are a TPU's peaks (197 TFLOP/s, 819 GB/s)
H100_PEAKS = {"--peak_tflops", "--hbm_gbs"}


def _jax_flags(tool):
    """{flag: (default, choices)} of the JAX tool's ``add_argument`` calls."""
    flags = {}
    for node in ast.walk(ast.parse((ROOT / "tools" / tool).read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg in ("default", "choices")}
            flags[node.args[0].value] = (kw.get("default"), kw.get("choices"))
    return flags


@pytest.mark.parametrize("tool", sorted(RUNNERS))
def test_runner_flags_are_the_jax_tools(tool):
    runner, extra = RUNNERS[tool]
    port = {(a.option_strings or [a.dest])[0]: (a.default, a.choices)
            for a in _load(f"tools/{runner}").parser()._actions if a.dest != "help"}
    jax_flags = _jax_flags(tool)
    assert set(port) - set(jax_flags) == extra
    for flag, (default, choices) in jax_flags.items():
        if flag in H100_PEAKS:
            assert default is not None and port[flag] == (None, None), flag
        else:
            assert port[flag] == (default, choices), flag
    if "--device" in extra:
        assert port["--device"][0] == "cuda"


def test_profile_and_roofline_runners(tmp_path, monkeypatch, capsys):
    """The profile runner's arguments and lines (the profile itself stubbed:
    `test_time_sub_discriminators_on_the_cpu` runs it), then the roofline
    runner on its JSONL."""
    seen = {}
    rows = [{"disc": n, "fwd_ms": 40.0, "fwd_bwd_ms": 90.0, "precision": "high",
             "dtype": "f32", "device": "cpu"} for n in NAMES] + [{"total_fwd_ms": 320.0,
                                                                  "card": None}]

    def fake(*args, **kw):
        seen.update(args=args, kw=kw)
        return rows

    monkeypatch.setattr(prof, "time_sub_discriminators", fake)
    profile, table = tmp_path / "rows.jsonl", tmp_path / "roofline.jsonl"
    assert _load("tools/torch_disc_profile.py").main(
        ["--n_iter", "3", "--precision", "high", "--device", "cpu", "--out", str(profile)]) == 0
    assert seen == {"args": (16, 8192, 3, "high", "f32"), "kw": {"device": "cpu"}}
    assert [json.loads(line) for line in profile.read_text().splitlines()] == rows
    assert capsys.readouterr().out.count("\n") == len(rows)
    assert _load("tools/torch_disc_roofline.py").main([str(profile), "--out", str(table)]) == 0
    out = capsys.readouterr().out
    assert "| mpd_p2 |" in out and "total fwd+bwd (f32 high): 720.00 ms" in out
    assert ([json.loads(line) for line in table.read_text().splitlines()]
            == roof.roofline(rows, 16, 8192))


def test_probe_runner_writes_its_lines(tmp_path, monkeypatch, capsys):
    seen = {}

    def fake(*args, **kw):
        seen.update(args=args, kw=kw)
        return {"f32": {"traj": {}}, "bf16": {"traj": {}}, "summary": {"steps": args[0]},
                "card": None}

    monkeypatch.setattr(probe, "bf16_probe", fake)
    out = tmp_path / "probe.jsonl"
    argv = ["--steps", "8", "--seed", "2", "--device", "cpu", "--out", str(out)]
    assert _load("tools/torch_disc_bf16_probe.py").main(argv) == 0
    assert seen == {"args": (8, 16, 32, "default", 2), "kw": {"device": "cpu"}}
    records = [json.loads(line) for line in out.read_text().splitlines()]
    assert records == [{"f32": {"traj": {}}}, {"bf16": {"traj": {}}}, {"steps": 8},
                       {"card": None}]
    assert capsys.readouterr().out.count("\n") == 4


# -- the bf16 probe ----------------------------------------------------------------------


def _jax_summary_keys():
    tree = ast.parse((ROOT / "tools" / "disc_bf16_probe.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets if isinstance(t, ast.Name)] == ["summary"]):
            return [k.value for k in node.value.keys]
    raise AssertionError("no summary dict in tools/disc_bf16_probe.py")


@pytest.fixture(scope="module")
def probe_run(jax_side):
    """The port's probe from JAX's initial state (its MSD at `PROBE_MSD`), and
    JAX's step 1."""
    state = jax_side.init.result()[0]

    def from_jax(cfg, periods, n_scales, seed, device):
        """`init_vocoder_train_state` with JAX's weights."""
        assert (cfg, periods, n_scales, str(device)) == (HiFiGANConfig(**TINY_KW), (2,), 1, "cpu")
        with torch.device("meta"):
            gen, disc = HiFiGANGenerator(cfg), Discriminators(periods, n_scales)
        gen.load_state_dict(state_dict_from_tree(state.gen_params), assign=True)
        disc.load_state_dict(discriminators_state_dict_from_tree(state.disc_params), assign=True)
        return vt.VocoderTrainState(gen, disc, vt.make_vocoder_optimizer(gen.parameters()),
                                    vt.make_vocoder_optimizer(disc.parameters()))

    mp = pytest.MonkeyPatch()
    mp.setattr(probe, "init_vocoder_train_state", from_jax)
    try:
        with _probe_msd(hifigan_disc):
            res = probe.bf16_probe(**PROBE, cfg=HiFiGANConfig(**TINY_KW), periods=(2,),
                                   n_scales=1, device="cpu")
    finally:
        mp.undo()
    return jax_side.jpool, jax_side.step1.result(), res


def test_probe_pool_is_the_jax_tools(probe_run):
    jpool = probe_run[0]
    pool = probe.synthetic_pool(PROBE["batch_size"], PROBE["segment_frames"])
    assert len(pool) == len(jpool) == 4
    for (mel, wav), (jmel, jwav) in zip(pool, jpool):
        assert mel.dtype == wav.dtype == np.float32
        assert np.array_equal(mel, np.asarray(jmel)) and np.array_equal(wav, np.asarray(jwav))
    assert probe.synthetic_pool(2, 16, seed=1)[0][0].tobytes() != pool[0][0].tobytes()


def test_probe_tracks_jax_and_fp32(probe_run):
    _, jax_step1, res = probe_run
    s = PROBE["steps"]
    assert probe.checkpoints(s) == sorted({1, s // 4, s // 2, s})
    for mode in probe.MODES:
        run = res[mode]
        assert sorted(run["traj"]) == [1, 3]  # checkpoint 0 is never reached, as in JAX
        assert run["device"] == "cpu" and run["skipped_last"] == 0.0
        assert run["skipped_steps"] == 0 and run["finite"] and run["fp32_state"]
        assert run["steps_per_s"] > 0
    f32, bf16 = res["f32"]["traj"][1], res["bf16"]["traj"][1]
    for k in probe.TRACKED:
        assert abs(f32[k] - jax_step1[k]) < 1e-5 * abs(jax_step1[k]), (k, f32[k], jax_step1[k])
        # JAX's bar for bf16-D against fp32 (tests/test_vocoder_training.py:98-102)
        assert abs(bf16[k] - f32[k]) < 0.08 * max(1.0, abs(f32[k])), (k, bf16[k], f32[k])
    gaps = probe.first_step_gaps(res)
    assert set(gaps) == set(probe.TRACKED) and all(g < probe.BF16_BAR for g in gaps.values())


def test_probe_summary_has_the_jax_tools_keys(probe_run):
    res = probe_run[2]
    assert list(res["summary"]) == _jax_summary_keys()
    summary = res["summary"]
    assert summary["final_g_mel_bf16"] == res["bf16"]["traj"][3]["g_mel"]
    assert summary["speedup"] == pytest.approx(summary["steps_per_s_bf16"]
                                               / summary["steps_per_s_f32"])
    assert summary["device"] == "cpu" and res["card"] is None


# -- the profile's function ----------------------------------------------------------


@pytest.fixture(scope="module")
def disc_case(jax_side):
    """The port's discriminators on ``jax_side``'s weights, its wav, and JAX's
    loss and gradients per sub-discriminator."""
    tree, wav, ref = jax_side.profile.result()
    with torch.device("meta"):
        disc = Discriminators()
    disc.load_state_dict(discriminators_state_dict_from_tree(tree), assign=True)
    return disc, torch.from_numpy(wav), ref


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_profile_loss_matches_the_jax_tool(disc_case, dtype):
    """fp32: the loss within 1e-5 relative and every parameter gradient within
    1e-5 of its max |g|; bf16 (wav and weights cast, as ``--dtype bf16``
    casts them): the loss within 2e-2 relative of JAX's fp32 loss, bf16's
    rounding over a dozen layers."""
    disc, wav, ref = disc_case
    dt = prof.DTYPES[dtype]
    seen = []
    for name, sub, x in prof.sub_discriminators(disc, wav if dt is None else wav.to(dt)):
        seen.append(name)
        params = list(sub.parameters())
        loss = prof.profile_loss(sub(x, dt))
        assert loss.dtype == torch.float32
        want, want_grads = float(ref[name][0]), ref[name][1]
        if dtype == "bf16":
            assert abs(loss.item() - want) < 2e-2 * abs(want), (name, loss.item(), want)
            continue
        assert abs(loss.item() - want) < 1e-5 * abs(want), (name, loss.item(), want)
        grads = dict(zip((n for n, _ in sub.named_parameters()),
                         torch.autograd.grad(loss, params)))
        for pname, g in state_dict_from_tree(jax.tree.map(np.asarray, want_grads)).items():
            scale = float(g.abs().max())
            assert float((grads[pname] - g).abs().max()) <= 1e-5 * scale, (name, pname)
    assert seen == NAMES
