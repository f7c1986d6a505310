"""chip_smoke.py, the bring-up check run on the GPU, exercised on the
CPU: it refuses a platform that is not a GPU, its --rehearse mode runs
every phase in-process at tiny sizes, and its last line has the exact
shape its callers parse."""
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        chip_smoke.main(argv)
    return buf.getvalue().splitlines()


def test_refuses_a_platform_that_is_not_a_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert "no GPU found" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("alone", [False, True])
def test_script_exits_nonzero_without_a_gpu(tmp_path, alone):
    """As a program: non-zero exit and no result line, both in the repo
    (no GPU) and copied into a directory that holds nothing else of the
    repo (no package)."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    if not alone:
        assert "no GPU found" in out.stderr


@pytest.fixture(scope="module")
def rehearsal():
    return _run(["--rehearse"])


def test_rehearsal_runs_every_phase(rehearsal):
    text = "\n".join(rehearsal)
    for phase in ("device: platform cpu", "nvidia-smi name, power.limit",
                  "extractor 512^2: compile", "bench.py gates",
                  "config-6 gates", "WFR sweep", "DCT-II",
                  "weighted unwrap", "map_coordinates",
                  "unit-cell average", "expand:"):
        assert phase in text, phase
    assert "FAILED" not in text


def test_last_line_contract(rehearsal):
    last = json.loads(rehearsal[-1])
    assert last == {"ok": True, "device": {"platform": "cpu",
                                           "kind": last["device"]["kind"],
                                           "count": 1}}
    assert isinstance(last["device"]["kind"], str)


def test_four_device_rehearsal():
    """--four runs only the parallel/ paths, on 4 of the suite's 8
    virtual CPU devices, each result spread over all 4."""
    lines = _run(["--four", "--rehearse"])
    text = "\n".join(lines)
    assert text.count("output on 4 devices") == 3
    assert "extractor 512^2" not in text
    assert json.loads(lines[-1])["device"]["count"] == 4
