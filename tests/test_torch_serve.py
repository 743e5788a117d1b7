"""The port's serving launcher (`python -m repro_torch.launch.serve`)
against the reference's (`repro.launch.serve`) at the same flags: the
same accuracies on every printed line (the single-camera MadEye, the
`fleet x4 [tables]` run and the six baselines), the same validation
messages, a JSONL telemetry stream that validates, and no fallback to
the CPU unless asked.
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.obs import read_events, validate_event  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FLAGS = dict(fps=2.0, duration=3.0, fleet=4)
ACC_LINE = re.compile(r"^(.+?)\s*:\s*acc=([0-9.]+)", re.M)


def _accuracies(text: str) -> dict:
    return {k.strip(): v for k, v in ACC_LINE.findall(text)}


@pytest.fixture(scope="module")
def jax_output():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jserve.serve(**FLAGS)
    return buf.getvalue()


def test_serve_prints_the_reference_accuracies(jax_output, capsys):
    tserve.serve(**FLAGS, device="cpu")
    out = capsys.readouterr().out
    got, want = _accuracies(out), _accuracies(jax_output)
    assert sorted(got) == sorted(want) == sorted(
        ["MadEye", "fleet x4    [tables]", "one_time_fixed", "best_fixed",
         "best_dynamic", "panoptes", "tracking", "ucb1"])
    assert got == want
    assert "(45 frames x 25 cells)" in out


def test_serve_fleet_telemetry_subprocess(jax_output):
    """`serve --device cpu --fleet 4 --telemetry -` end to end: rc 0, the
    reference's accuracies, and a validatable JSONL stream interleaved
    with the human log."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--fps", "2", "--duration", "3", "--fleet", "4", "--telemetry",
         "-"], capture_output=True, text=True, timeout=300, env=env,
        cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    events = [validate_event(json.loads(ln))
              for ln in proc.stdout.splitlines() if ln.startswith("{")]
    kinds = [e["event"] for e in events]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert "steps" in kinds
    assert events[0]["n_cameras"] == 4 and events[0]["metrics"] is True
    assert events[-1]["metrics_summary"] is not None
    assert _accuracies(proc.stdout) == _accuracies(jax_output)


@pytest.mark.parametrize("kwargs", [
    dict(fleet=-1),
    dict(fleet=2, provider="nope"),
    dict(fleet=2, shortlist_k=18),
    dict(fleet=2, provider="scene", distill=True),
])
def test_serve_refuses_what_the_reference_refuses(kwargs):
    with pytest.raises(SystemExit) as want:
        jserve.serve(1.0, 1.0, **kwargs)
    with pytest.raises(SystemExit) as got:
        tserve.serve(1.0, 1.0, **kwargs, device="cpu")
    assert str(got.value) == str(want.value)


def test_serve_never_falls_back_to_cpu(capsys):
    """Without a card, serve not told device='cpu' raises before it
    builds the substrate."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve(**FLAGS)
    assert capsys.readouterr().out == ""


def test_serve_detector_distill_telemetry(tmp_path, capsys):
    """`--provider detector --shortlist-k 18 --distill --telemetry PATH`
    through the port's providers: the distill line and events that carry
    each camera's distill_loss."""
    path = str(tmp_path / "tel.jsonl")
    tserve.serve(3.0, 1.0, fleet=2, provider="detector", shortlist_k=18,
                 distill=True, telemetry=path, device="cpu")
    out = capsys.readouterr().out
    assert "fleet x2    [detector]: acc=" in out
    assert "  distill: " in out
    assert f"  telemetry: 3 events -> {path}" in out
    events = read_events(path)
    steps = [e for e in events if e["event"] == "steps"]
    assert steps and all(len(e["cameras"]["distill_loss"]) == 2
                         for e in steps)
    assert events[0]["spec"]["shortlist_k"] == 18
    assert events[0]["spec"]["distill"] is not None
