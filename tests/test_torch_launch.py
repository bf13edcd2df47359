"""The port's launchers run end to end on the CPU, in a subprocess:
``repro_torch.launch.train --managed`` submits a reduced trainer to a
CACS service, checkpoints it, restarts it from the image and runs it to
the end; the raw loop checkpoints and resumes; ``launch.serve --managed``
serves under the service; ``launch.serve`` serves a reduced xLSTM model."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(cwd))
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    return r.stdout


TRAIN = ["repro_torch.launch.train", "--reduced", "--device", "cpu",
         "--batch", "2", "--seq", "32", "--ckpt-dir", "ck"]


def test_managed_train_checkpoints_restarts_and_finishes(tmp_path):
    out = _run(TRAIN + ["--managed", "--steps", "12", "--ckpt-period", "0.5"],
               tmp_path)
    assert "RUNNING on cpu" in out
    step = int(re.search(r"checkpoint (\d+): [\d,]+ bytes, codec raw",
                         out).group(1))
    assert f"restarted from checkpoint {step} (restarts 1)" in out
    done = re.search(r"done: step=12 loss=([\d.]+) ckpts=\[([\d, ]+)\]", out)
    assert done, out
    assert 0 < float(done.group(1)) < 20
    assert max(int(s) for s in done.group(2).split(",")) >= step


def test_raw_train_loop_checkpoints_and_resumes(tmp_path):
    first = _run(TRAIN + ["--steps", "4", "--ckpt-period", "1000"], tmp_path)
    assert first.strip().endswith("done: checkpoints [4]")
    again = _run(TRAIN + ["--steps", "6", "--ckpt-period", "1000",
                          "--resume"], tmp_path)
    assert "resumed from step 4" in again
    assert again.strip().endswith("done: checkpoints [4, 6]")


def test_managed_serve_runs_to_the_end(tmp_path):
    out = _run(["repro_torch.launch.serve", "--managed", "--reduced",
                "--device", "cpu", "--tokens", "6"], tmp_path)
    assert "generated 6/6" in out and "tokens: [[" in out


def test_serve_runs_a_reduced_xlstm_model_on_the_cpu(tmp_path):
    out = _run(["repro_torch.launch.serve", "--arch", "xlstm-125m",
                "--reduced", "--device", "cpu", "--tokens", "6"], tmp_path)
    assert "generated (2, 6) on cpu" in out
