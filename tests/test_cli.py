"""CLI end-to-end coverage: `firefly render` → image file → parse round
trip (the reference's Ctrl+S → saveToPPM path, utilities.h:842-893 — except
ours writes pixels the renderer actually produced, unlike the reference's
stale-buffer bug, SURVEY.md §2.3.10)."""

import json
import os

import numpy as np

from gpupathtracer_tpu.cli import main
from gpupathtracer_tpu.utils.image import read_ppm

CONFIG1 = os.path.join(os.path.dirname(os.path.dirname(__file__)), "scenes", "config1_triangle.toml")


def test_render_cli_ppm_roundtrip(tmp_path, capsys):
    out = str(tmp_path / "c1.ppm")
    rc = main(
        ["render", CONFIG1, "--out", out, "--spp", "2"]
    )
    assert rc == 0
    assert "rendered 256x256" in capsys.readouterr().out
    img = read_ppm(out)
    assert img.shape == (256, 256, 3) and img.dtype == np.uint8
    # Config 1: emitter backdrop (Le=2 clamps to white) with the black
    # triangle silhouette in front.
    assert (img == 255).mean() > 0.3
    assert (img == 0).all(axis=-1).mean() > 0.02


def test_render_cli_checkpointed_resume(tmp_path, capsys):
    """Progressive + checkpoint through the CLI: a rerun resumes (no-op)
    and produces the identical image file."""
    out1 = str(tmp_path / "a.ppm")
    out2 = str(tmp_path / "b.ppm")
    ck = str(tmp_path / "film.npz")
    args = [
        "render", CONFIG1,
        "--spp", "4", "--chunk-spp", "2", "--checkpoint", ck,
    ]
    assert main(args + ["--out", out1]) == 0
    assert os.path.exists(ck)
    assert main(args + ["--out", out2]) == 0  # fully resumed from checkpoint
    capsys.readouterr()
    np.testing.assert_array_equal(read_ppm(out1), read_ppm(out2))


def test_benchmark_cli_json(tmp_path, capsys):
    """`firefly benchmark` emits the driver-consumable JSON line."""
    rc = main(
        ["benchmark", "--scene", CONFIG1,
         "--iters", "1", "--warmup", "1"]
    )
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    result = json.loads(line)
    assert {"metric", "value", "unit", "vs_baseline"} <= set(result)
    assert result["value"] > 0


def test_main_path_imports_without_flax_and_pil(tmp_path):
    """The render path needs neither flax nor PIL (the GPU machine is not
    sure to have them): block both imports and render config 5 to a PNG."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "c5.png")
    code = (
        "import sys; sys.modules['flax'] = None; sys.modules['PIL'] = None\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "from gpupathtracer_tpu import cli\n"
        "from gpupathtracer_tpu.utils.image import read_png\n"
        f"rc = cli.main(['render', {os.path.join(repo, 'scenes', 'config5_invert_target.toml')!r},"
        f" '--out', {out!r}, '--spp', '1'])\n"
        f"assert rc == 0 and read_png({out!r}).shape == (128, 128, 3)\n"
    )
    env = dict(os.environ, PYTHONPATH=repo, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    done = subprocess.run(
        [sys.executable, "-c", code], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert done.returncode == 0, done.stderr[-2000:]
