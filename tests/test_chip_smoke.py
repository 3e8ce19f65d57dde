"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusal of a
machine without a GPU. The full-size run needs the card."""
import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def test_device_phase_refuses_cpu():
    with pytest.raises(chip_smoke.PhaseError, match="no GPU"):
        chip_smoke.phase_device()
    assert chip_smoke.phase_device(require_gpu=False)["platform"] == "cpu"


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_alone_fails(tmp_path):
    """Copied into a directory without the package, the script fails and
    prints no result."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_reference_phase():
    st = chip_smoke.phase_reference(("simple_sphere",))
    assert st["simple_sphere"]["rate"] >= 0.97


def test_cpu_oracle_phase():
    st = chip_smoke.phase_cpu_oracle(width=24, spp=4, depth=4)
    assert st["rel_mean"] == 0.0 and st["paths"] == 1.0   # same backend


def test_forward_phase(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    st = chip_smoke.phase_forward(width=24, spp=4, depth=4, steps=2)
    assert len(st["step_s"]) == 2
    assert (tmp_path / "output" / "chip_smoke_static.ppm").exists()


def test_training_phase():
    st = chip_smoke.phase_training(width=24, spp=4, depth=4, steps=3)
    assert st["losses"][-1] < st["losses"][0]


def test_gradients_phase():
    st = chip_smoke.phase_gradients(width=16, spp=4, depth=4)
    assert st["fd_rel"] <= 5e-3


def test_train_memory_phase():
    st = chip_smoke.phase_train_memory(width=32, height=18, spp=4, depth=4)
    assert st["step_s"] > 0


def test_four_cards_phase_on_virtual_devices():
    st = chip_smoke.phase_four_cards(width=16, spp=4, depth=4,
                                     devices=jax.devices()[:4])
    assert all(v <= 1e-4 for v in st["grad_rel"].values())


@pytest.mark.gpu
def test_chip_smoke_small_phases_on_gpu(gpu):
    """On the card: the GPU-vs-CPU phases at small size."""
    chip_smoke.phase_cpu_oracle(width=48, spp=4, depth=8)
    chip_smoke.phase_gradients(width=32, spp=4, depth=4)

