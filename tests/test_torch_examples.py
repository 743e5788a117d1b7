"""The port's examples (`python -m repro_torch.examples.<name>`) run end
to end as subprocesses on the CPU, with the REPRO_EX_* overrides of
tests/test_examples_smoke.py, and reach the reference examples' result
lines; without a card and without `--device cpu` they refuse to run.
The quickstart (host numpy only, no device) prints the reference
quickstart's accuracies."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXAMPLES = [
    ("adaptive_serving",
     {"REPRO_EX_DURATION": "2.0", "REPRO_EX_STEPS": "3"},
     "NN-in-the-loop MadEye accuracy"),
    ("continual_distillation",
     {"REPRO_EX_DURATION": "2.0", "REPRO_EX_EVALS": "4"},
     "replay: rank quality"),
    ("fleet_experiment",
     {"REPRO_EX_CAMERAS": "2", "REPRO_EX_STEPS": "3"},
     "fleet accuracy"),
]


def _run(args, env_overrides):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    env.update(env_overrides)
    return subprocess.run([sys.executable, "-m", *args], env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("name,overrides,marker", EXAMPLES,
                         ids=[e[0] for e in EXAMPLES])
def test_example_runs_on_cpu(name, overrides, marker):
    proc = _run([f"repro_torch.examples.{name}", "--device", "cpu"],
                overrides)
    assert proc.returncode == 0, \
        f"{name} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}"
    assert marker in proc.stdout, \
        f"{name} did not reach its result line:\n{proc.stdout[-2000:]}"


def test_example_needs_a_card_unless_told_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _run(["repro_torch.examples.fleet_experiment"],
                {"REPRO_EX_CAMERAS": "1", "REPRO_EX_STEPS": "1"})
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_quickstart_prints_the_reference_accuracies():
    """`python -m repro_torch.examples.quickstart` and the reference's
    examples/quickstart.py at REPRO_EX_DURATION=2.0: the same result
    lines (MadEye's and the three baselines')."""
    env = {"REPRO_EX_DURATION": "2.0"}
    port = _run(["repro_torch.examples.quickstart"], env)
    ref = subprocess.run([sys.executable,
                          os.path.join(REPO, "examples", "quickstart.py")],
                         env={**os.environ, **env,
                              "PYTHONPATH": os.path.join(REPO, "src")},
                         capture_output=True, text=True, timeout=300)
    assert port.returncode == 0 and ref.returncode == 0, \
        port.stderr[-2000:] + ref.stderr[-2000:]

    def results(out):
        return [ln for ln in out.splitlines() if "accuracy" in ln]

    assert len(results(port.stdout)) == 4
    assert results(port.stdout) == results(ref.stdout)


def test_train_lm_example_learns_on_cpu():
    """`python -m repro_torch.examples.train_lm --steps 30 --device cpu`
    (its default is 200 steps): the held-out loss ends below the loss at
    init, and the temporary checkpoint directory is removed."""
    proc = _run(["repro_torch.examples.train_lm", "--steps", "30",
                 "--device", "cpu"], {})
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("held-out loss")][-1]
    final, init = float(line.split()[2]), float(line.split()[5].rstrip(";"))
    assert final < init, line
    ckpt_dir = proc.stdout.split("ckpt -> ")[1].splitlines()[0]
    assert not os.path.exists(ckpt_dir)

