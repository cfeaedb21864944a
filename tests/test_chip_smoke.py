"""chip_smoke.py on the CPU: its phases at a tiny size, its reference
rules, and its refusal to run anywhere but on a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_one_card_phases_tiny(tmp_path):
    lines = chip_smoke.run_one_card(chip_smoke.TINY, seed=0, root=str(tmp_path))
    names = [line.split(":")[0] for line in lines]
    assert names == [
        "phase config1", "phase config2", "phase ivf", "phase residency",
        "phase join", "phase mutations",
    ]
    assert all(": ok " in line for line in lines)


def test_four_card_mesh_paths_tiny(tmp_path):
    """The mesh paths against the one-card answer, here on the 8
    virtual CPU devices the test session runs with."""
    import jax

    lines = chip_smoke.run_four_cards(
        chip_smoke.TINY, seed=0, root=str(tmp_path), devices=len(jax.devices())
    )
    assert len(lines) == 4 and all(": ok" in line for line in lines)


def test_reference_allows_tie_swaps_only(rng):
    corpus = rng.standard_normal((64, 8)).astype(np.float32)
    corpus[10] = corpus[3]  # exact duplicate: rows 3 and 10 tie
    queries = corpus[3:4] + 0.01
    want_d, want_i = chip_smoke.ref_topk(corpus, queries, "l2", 4)
    assert set(want_i[0, :2].tolist()) == {3, 10}
    sizes = chip_smoke.TINY
    swapped = want_i[:, :4].copy()
    swapped[0, [0, 1]] = swapped[0, [1, 0]]
    chip_smoke.check_search("swap", swapped, want_d[:, :4], corpus, queries, "l2", 4, sizes)
    wrong = want_i[:, :4].copy()
    wrong[0, 3] = want_i[0, 4] if want_i[0, 4] not in wrong[0] else 63
    with pytest.raises(AssertionError):
        chip_smoke.check_search("wrong", wrong, want_d[:, :4], corpus, queries, "l2", 4,
                                sizes)


def test_main_refuses_a_cpu_backend(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "test card, 700.00 W")
    monkeypatch.setattr(chip_smoke, "phase_gpu_tests", lambda: "0 passed")
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    monkeypatch.setenv("FENIX_MESH", os.environ.get("FENIX_MESH", "auto"))
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main()
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_alone_in_a_directory_it_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    last = (out.stdout.strip().splitlines() or [""])[-1]
    with pytest.raises(json.JSONDecodeError):
        json.loads(last)
