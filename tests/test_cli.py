"""CLI smoke tests: cora-makesky subcommands and the HDF5 map schema."""

from pathlib import Path

import numpy as np
import h5py
import pytest
from click.testing import CliRunner

from cora_tpu.scripts.makesky import cli, FreqState


def test_freqstate_modes():
    fs = FreqState()
    fs.freq = (800.0, 400.0, 4)
    fs.freq_mode = "centre"
    assert np.allclose(fs.frequencies, [800.0, 700.0, 600.0, 500.0])
    assert fs.freq_width == 100.0

    fs.freq_mode = "centre_nyquist"
    assert np.allclose(fs.frequencies, np.linspace(800, 400, 4))

    fs.freq_mode = "edge"
    assert np.allclose(fs.frequencies, [750.0, 650.0, 550.0, 450.0])

    fs.freq_mode = "centre"
    fs.channel_bin = 2
    assert np.allclose(fs.frequencies, [750.0, 550.0])

    fs.channel_bin = 1
    fs.channel_list = [0, 2]
    assert np.allclose(fs.frequencies, [800.0, 600.0])


def _check_map_schema(fname, nfreq, npol, nside):
    with h5py.File(fname, "r") as f:
        assert f.attrs["__memh5_distributed_file"]
        m = f["map"]
        assert m.shape == (nfreq, npol, 12 * nside**2)
        assert list(m.attrs["axis"]) == ["freq", "pol", "pixel"]
        fm = f["index_map/freq"][:]
        assert fm.dtype.names == ("centre", "width")
        assert len(f["index_map/pol"][:]) == npol
        assert len(f["index_map/pixel"][:]) == 12 * nside**2
        return m[:]


@pytest.mark.slow
def test_cli_21cm(tmp_path):
    out = str(tmp_path / "map.h5")
    runner = CliRunner()
    res = runner.invoke(
        cli,
        [
            "21cm",
            "--nside", "16",
            "--freq", "400", "416", "4",
            "--pol", "zero",
            "--oversample", "1",
            "--seed", "1",
            "--filename", out,
        ],
        catch_exceptions=False,
    )
    assert res.exit_code == 0
    m = _check_map_schema(out, 4, 4, 16)
    assert m[:, 0].std() > 0
    assert (m[:, 1:] == 0).all()


def test_cli_singlesource(tmp_path):
    out = str(tmp_path / "src.h5")
    runner = CliRunner()
    res = runner.invoke(
        cli,
        [
            "singlesource",
            "--nside", "16",
            "--freq", "400", "420", "2",
            "--ra", "90.0",
            "--dec", "30.0",
            "--filename", out,
        ],
        catch_exceptions=False,
    )
    assert res.exit_code == 0
    m = _check_map_schema(out, 2, 4, 16)
    assert m.sum() == 2.0  # one unit source per frequency

    from cora_tpu.healpix import pixel

    ipix = pixel.ang2pix(16, np.radians(90 - 30.0), np.radians(90.0))[0]
    assert m[0, 0, ipix] == 1.0


def test_cli_pointsource(tmp_path):
    out = str(tmp_path / "ps.h5")
    runner = CliRunner()
    res = runner.invoke(
        cli,
        [
            "pointsource",
            "--nside", "16",
            "--freq", "400", "440", "4",
            "--pol", "none",
            "--seed", "3",
            "--filename", out,
        ],
        catch_exceptions=False,
    )
    assert res.exit_code == 0
    m = _check_map_schema(out, 4, 1, 16)
    assert np.isfinite(m).all()
    assert m[:, 0].std() > 0


def test_cli_gaussianfg(tmp_path):
    out = str(tmp_path / "fg.h5")
    runner = CliRunner()
    res = runner.invoke(
        cli,
        [
            "gaussianfg",
            "--nside", "16",
            "--freq", "400", "416", "4",
            "--pol", "zero",
            "--seed", "2",
            "--filename", out,
        ],
        catch_exceptions=False,
    )
    assert res.exit_code == 0
    # gaussianfg with pol=zero writes a single (I) pol component, matching
    # the reference (makesky.py:368 npol = 4 if pol == "full" else 1)
    m = _check_map_schema(out, 4, 1, 16)
    assert m[:, 0].std() > 0


@pytest.mark.slow
def test_cli_galaxy(tmp_path):
    out = str(tmp_path / "gal.h5")
    runner = CliRunner()
    res = runner.invoke(
        cli,
        [
            "galaxy",
            "--nside", "16",
            "--freq", "400", "416", "4",
            "--pol", "zero",
            "--seed", "3",
            "--filename", out,
        ],
        catch_exceptions=False,
    )
    assert res.exit_code == 0
    m = _check_map_schema(out, 4, 4, 16)
    # galactic synchrotron: K-scale positive-mean emission
    assert m[:, 0].mean() > 0.5


@pytest.mark.slow
def test_cli_foreground(tmp_path):
    out = str(tmp_path / "fore.h5")
    runner = CliRunner()
    res = runner.invoke(
        cli,
        [
            "foreground",
            "--nside", "16",
            "--freq", "400", "416", "4",
            "--pol", "zero",
            "--seed", "4",
            "--filename", out,
        ],
        catch_exceptions=False,
    )
    assert res.exit_code == 0
    m = _check_map_schema(out, 4, 4, 16)
    assert m[:, 0].std() > 0


def test_api_parity_audit():
    """Every public reference symbol has a cora_tpu counterpart (or a
    documented intentional absence) — tools/api_audit.py as a regression."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    ref = Path("/root/reference")
    if not ref.exists():
        import pytest

        pytest.skip("reference checkout not available")
    r = subprocess.run(
        [sys.executable, str(root / "tools" / "api_audit.py"),
         "--reference", str(ref)],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "/" in r.stdout and "MISSING" not in r.stdout


def test_enable_compile_cache(tmp_path, monkeypatch):
    """enable_compile_cache populates the persistent XLA cache in the
    directory JAX_COMPILATION_CACHE_DIR names, so repeat CLI invocations
    skip compiles."""
    import jax
    import jax.numpy as jnp

    from cora_tpu.util.compute import enable_compile_cache

    d = tmp_path / "xla"
    prev = jax.config.jax_compilation_cache_dir
    prev_min = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(d))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        assert enable_compile_cache() == str(d)
        jax.jit(lambda x: jnp.sin(x) * 2.0 + x)(jnp.arange(1000.0)).block_until_ready()
        assert any(d.iterdir()), "no cache entries written"
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", prev_min)
        jax.config.update("jax_compilation_cache_dir", prev)
        from jax._src import compilation_cache as _cc

        _cc.reset_cache()


@pytest.mark.parametrize("env", [None, "set"])
def test_compile_cache_placement(tmp_path, monkeypatch, env):
    """The compile cache goes where JAX_COMPILATION_CACHE_DIR says, else to
    <checkout>/.jax_cache; no other directory is ever configured."""
    import jax

    from cora_tpu.util.compute import compile_cache_dir, enable_compile_cache

    root = Path(__file__).resolve().parent.parent
    want = str(tmp_path / "cc") if env else str(root / ".jax_cache")
    if env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    prev = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache_dir() == want
        assert enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
        from jax._src import compilation_cache as _cc

        _cc.reset_cache()
