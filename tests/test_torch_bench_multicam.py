"""``bench_multicam_torch.py`` against the JAX ``bench_multicam.py`` on the
same rig, on the CPU: 3 cameras x 40 frames (the programs' gates hold
there).  ``tests/conftest.py`` gives JAX 8 CPU devices, so the JAX program
takes its sharded mixed route (``multi_ba_sharded_mixed``); the port runs
the same route over eight CPU devices.  ``testdata.rig_problem`` draws
``bench_multicam.py``'s numbers in its order, so both solve the same
observations.  Tolerances: the same JSON keys (plus the port's
``device``), ``rms_px`` equal (both round to 1e-4 px), the focal and
extrinsic errors within 1e-8 absolute (two sharded solves of the same
problem agree to about 1e-9 relative: the reduction order differs)."""

import jax
import torch

import bench_multicam
import bench_multicam_torch

torch.set_num_threads(1)


def test_same_rig_same_result_as_the_jax_program():
    assert len(jax.devices()) == 8
    want = bench_multicam.run(C=3, F=40)
    got = bench_multicam_torch.run(C=3, F=40, devices=["cpu"] * 8)
    assert set(got) == set(want) | {"device"}
    assert got["device"] == "cpu"
    for key in ("metric", "unit", "rms_gate", "rms_px"):
        assert got[key] == want[key], key
    for key in ("max_focal_rel_err", "max_extrinsic_err"):
        assert abs(got[key] - want[key]) < 1e-8, (key, got[key], want[key])
    assert got["max_focal_rel_err"] < 3e-3 and got["max_extrinsic_err"] < 3e-3
    assert 0.07 < got["rms_px"] < 0.13
    assert got["value"] > 0 and got["iters"] > 0
