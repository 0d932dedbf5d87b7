"""Every JAX-side tool in ``tools/`` has a counterpart in the port or is
listed as pending in ``ROADMAP.md`` section 1.

A tool is JAX-side when it imports ``jax``, the JAX package, ``bench`` or
``tools.demo_common`` (read with ``ast``; nothing is imported).  Its row in
`TOOLS` names the port's files that do its job, each of which must exist,
or marks it pending, and then ROADMAP.md's section 1 must name it.  No
row declares a tool unneeded, so the surface cannot be called complete
while a tool is missing.
"""

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_SIDE = {"jax", "spev_tpu", "bench", "tools.demo_common"}
PENDING = "pending"

TOOLS = {
    "advanced_controls_demo.py": ("tools/torch_advanced_controls_demo.py",
                                  "spev_tpu_torch/diag/evidence.py"),
    "emotion_register_demo.py": ("tools/torch_emotion_register_demo.py",
                                 "spev_tpu_torch/diag/evidence.py"),
    "multispeaker_demo.py": ("tools/torch_multispeaker_demo.py",
                             "spev_tpu_torch/diag/evidence.py"),
    "quality256_run.py": ("tools/torch_quality_run.py",),
    # the TPU profilers: chip_smoke.py's profiled phases and the kernel A/B
    "tpu_serving_overhead.py": ("chip_smoke.py", "spev_tpu_torch/diag/kernel_ab.py"),
    "tpu_step_anatomy.py": ("chip_smoke.py", "spev_tpu_torch/diag/kernel_ab.py"),
    "tpu_train_profile.py": ("chip_smoke.py", "spev_tpu_torch/diag/kernel_ab.py"),
    "tpu_vocoder_profile.py": ("chip_smoke.py", "spev_tpu_torch/diag/kernel_ab.py"),
    # every entry point of the port takes --device cpu
    "cpu_cli.py": ("spev_tpu_torch/utils/platform.py",),
    # the formant-corpus quality gate and its demo page
    "demo_common.py": ("spev_tpu_torch/diag/convergence.py",),
    "gate_calibration.py": ("tools/torch_gate_calibration.py",
                            "spev_tpu_torch/diag/convergence.py"),
    "quality_trajectory.py": ("tools/torch_quality_trajectory.py",
                              "spev_tpu_torch/diag/convergence.py"),
    "make_demo.py": ("tools/torch_make_demo.py", "spev_tpu_torch/diag/convergence.py"),
    # the GAN-vocoder evidence
    "gan_copysynth.py": ("tools/torch_gan_copysynth.py",
                         "spev_tpu_torch/diag/vocoder_evidence.py"),
    "gta_demo.py": ("tools/torch_gta_demo.py", "spev_tpu_torch/diag/vocoder_evidence.py"),
    "prep_gta_work.py": ("tools/torch_prep_gta_work.py",
                         "spev_tpu_torch/diag/vocoder_evidence.py"),
    # the discriminator probes
    "tpu_disc_profile.py": ("tools/torch_disc_profile.py", "spev_tpu_torch/diag/disc_profile.py"),
    "disc_roofline.py": ("tools/torch_disc_roofline.py", "spev_tpu_torch/diag/disc_roofline.py"),
    "disc_bf16_probe.py": ("tools/torch_disc_bf16_probe.py",
                           "spev_tpu_torch/diag/disc_bf16_probe.py"),
}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _jax_side(path):
    return any(m in JAX_SIDE or m.split(".")[0] in JAX_SIDE for m in _imports(path))


def _jax_side_tools():
    return sorted(p.name for p in (ROOT / "tools").glob("*.py")
                  if not p.name.startswith("torch_") and _jax_side(p))


def _roadmap_section_1():
    text = (ROOT / "ROADMAP.md").read_text()
    m = re.search(r"^### 1\..*?(?=^### 2\.)", text, re.S | re.M)
    assert m, "ROADMAP.md has no section 1"
    return m.group(0)


def test_every_jax_side_tool_has_a_row():
    tools = _jax_side_tools()
    assert len(tools) >= 19
    assert sorted(TOOLS) == tools, (sorted(set(tools) - set(TOOLS)),
                                    sorted(set(TOOLS) - set(tools)))


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_row_is_ported_or_pending_in_the_roadmap(tool):
    row = TOOLS[tool]
    if row == PENDING:
        assert f"`tools/{tool}`" in _roadmap_section_1(), f"{tool} is not pending in ROADMAP.md"
    else:
        assert row and all((ROOT / f).is_file() for f in row), row


def test_the_port_tools_import_no_jax():
    for p in sorted((ROOT / "tools").glob("torch_*.py")):
        assert not _jax_side(p), p.name
