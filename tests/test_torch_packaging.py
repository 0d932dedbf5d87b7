"""F5: the port ships its kernel sources and builds its libraries where it
can write.

- `utils.platform.build_dir`: the package's ``_build/`` when it is
  writable (a checkout, as before), else ``$XDG_CACHE_HOME/spev_tpu_torch/
  build`` or ``~/.cache/spev_tpu_torch/build``; a directory whose mode
  grants no write counts as read-only even to root.
- A wheel of the checkout built offline (``chip_smoke.install_read_only``:
  ``pip wheel --no-deps --no-build-isolation --no-index`` on a copy) holds
  the three ``.cu`` sources and ``spevio.cpp``, and no built library.
  Installed with ``pip install --target`` into a directory made read-only,
  and imported first in a fresh process with a temporary
  ``XDG_CACHE_HOME``, the port builds ``libspevio`` into that cache and its
  C++ wav reader is bit-equal to the Python reader on a seeded wav; nothing
  is written into the installed package.  (``chip_smoke.py`` phase 20a does
  the same on the card, with the CUDA kernels.)
"""

import os

import pytest

import chip_smoke
from spev_tpu_torch.ops.cuda import build
from spev_tpu_torch.utils import native, platform

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_a_checkout_builds_in_the_package():
    local = os.path.join(ROOT, "spev_tpu_torch", "_build")
    assert platform.build_dir() == build.BUILD_DIR == native.BUILD_DIR == local


@pytest.mark.parametrize("case", ["writable", "read-only", "read-only, no XDG_CACHE_HOME"])
def test_build_dir_falls_back_to_the_user_cache(case, tmp_path, monkeypatch):
    pkg = tmp_path / "site" / "spev_tpu_torch"
    pkg.mkdir(parents=True)
    monkeypatch.setattr(platform, "_PKG", str(pkg))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if "no XDG" in case:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
    else:
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    if case != "writable":
        pkg.chmod(0o555)
    try:
        got = platform.build_dir()
    finally:
        pkg.chmod(0o755)
    want = {"writable": pkg / "_build",
            "read-only": tmp_path / "xdg" / "spev_tpu_torch" / "build",
            "read-only, no XDG_CACHE_HOME": tmp_path / "home" / ".cache" / "spev_tpu_torch" /
            "build"}[case]
    assert got == str(want)
    assert not (pkg / "_build").exists()


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    work = tmp_path_factory.mktemp("installed")
    wheel, names, target = chip_smoke.install_read_only(str(work))
    yield names, target, str(work)
    for d, _, _ in os.walk(target):  # writable again, for the cleanup
        os.chmod(d, 0o755)


def test_the_wheel_ships_the_sources(installed):
    names, target, _ = installed
    assert all(s in names for s in chip_smoke.WHEEL_SOURCES), chip_smoke.WHEEL_SOURCES
    assert not [n for n in names if n.endswith(".so") or "/_build/" in n]
    for s in chip_smoke.WHEEL_SOURCES:
        assert os.path.isfile(os.path.join(target, s))


def test_the_installed_port_builds_native_io_in_the_user_cache(installed):
    _, target, work = installed
    assert not os.stat(os.path.join(target, "spev_tpu_torch")).st_mode & 0o222
    cache = os.path.join(work, "xdg")
    os.makedirs(cache)
    before = chip_smoke.tree_state(target)
    res = chip_smoke.run_installed(target, cache, kernels=False)
    assert chip_smoke.tree_state(target) == before
    assert res["package"] == os.path.join(target, "spev_tpu_torch")
    assert res["build_dir"] == os.path.join(cache, "spev_tpu_torch", "build")
    assert os.listdir(res["build_dir"]) == [res["native_library"]]
    assert res["native_library"] == os.path.basename(native.library_path())
    assert res["samples"] == 22050
