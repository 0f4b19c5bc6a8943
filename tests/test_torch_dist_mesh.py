"""The distributed mesh (parallel/dist.py) against the in-process mesh on
the CPU, over gloo ranks spawned by ``launch`` (every world bounded by a
60 s deadline):

- every primitive of a 2x2 world (split / gather on the four specs,
  from_prev / from_next with and without ``ring`` on both axes, a batched
  ``exchange`` of mixed dtypes and diagonal requests, psum over "y", "x"
  and both, ``ext1`` and ``halos`` with and without ``ring_x``,
  axis_index, bases, wall_flags, the flat layout) bit for bit equal to
  ``Mesh(2, 2)``'s on the same seeded inputs, in f32 and f64;
- in-process, ``halos`` (one exchange round) equals the row round and the
  column round of the row-extended blocks it stands for, bit for bit;
- the command line under torchrun, on the sharded layout: ``run
  falling_block --nx 16 --mesh 2x2 --device cpu`` on 4 ranks, one step
  with a checkpoint and then one more resumed from it, writes metrics.jsonl
  lines (rank 0) equal but for the clocks to those of two straight steps
  of the in-process 2x2 mesh on the sharded layout, and the resumed run's
  checkpoint equals the straight run's bit for bit; the first checkpoint
  loads in the single-device port; ``--mesh 2x2`` on a rank of a 3-rank
  world exits with the reference's message; a world whose rank fails
  fails ``launch``, and one that outlives its deadline is killed.

The 8-rank FK 32^2 step is in tests/test_torch_mesh_step.py.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch_dist_workers as W

from pylamp_tpu_torch.parallel.dist import launch
from pylamp_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 60.0


def _local(ref, key, rank, mx):
    """The in-process result ``ref`` as rank ``rank`` holds it."""
    if key.startswith("gather_") or key == "split_r":
        return ref  # global tensors
    if key in ("bases", "wall_flags", "flat"):
        return ref[rank:rank + 1]  # the flat (S, ...) layout
    iy, ix = divmod(rank, mx)
    full = ref.expand(2, 2, *ref.shape[2:])
    return full[iy:iy + 1, ix:ix + 1]


def test_primitives_match_in_process_mesh():
    got = launch(4, W.primitives_rank, 2, 2, device="cpu",
                 timeout_s=DEADLINE_S)
    for dt in (torch.float32, torch.float64):
        ref = W.primitives(Mesh(2, 2), dt)
        for rank, res in enumerate(got):
            res = res[str(dt)]
            assert res.keys() == ref.keys()
            for key, r in ref.items():
                want, g = _local(r, key, rank, 2), res[key]
                assert g.dtype == want.dtype, (dt, rank, key)
                assert torch.equal(g, want), (dt, rank, key)


def test_launch_failure_and_deadline():
    """A failing rank fails the launch at once (the waiting rank killed);
    a world past its deadline is killed."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        launch(2, W.fail_rank, 1, device="cpu", timeout_s=DEADLINE_S)
    with pytest.raises(TimeoutError):
        launch(1, W.sleep_rank, 60.0, device="cpu", timeout_s=1.0)
    assert time.monotonic() - t0 < 30


def _two_rounds(mesh, a, up, down, left, right, top, bottom, ring):
    """What ``Mesh.halos`` stands for: a round of row halos (the walls'
    own rows at the domain's top / bottom), then a round of column halos
    of the row-extended block."""
    iy = mesh.axis_index("y")
    a = mesh._full(a)
    parts = [a]
    if up:
        t = mesh.from_prev(a[..., -up:, :], "y")
        parts.insert(0, t if top is None else torch.where(iy == 0, top, t))
    if down:
        b = mesh.from_next(a[..., :down, :], "y")
        parts.append(b if bottom is None
                     else torch.where(iy == mesh.my - 1, bottom, b))
    rows = torch.cat(parts, dim=-2)
    return (rows,
            mesh.from_prev(rows[..., -left:], "x", ring) if left else None,
            mesh.from_next(rows[..., :right], "x", ring) if right else None)


@pytest.mark.parametrize("my, mx", [(2, 2), (3, 2), (1, 3), (3, 1)])
@pytest.mark.parametrize("ring", [False, True])
def test_halos_one_round_equals_two(my, mx, ring):
    mesh = Mesh(my, mx)
    rng = np.random.default_rng(my * 10 + mx)
    a = mesh.split(torch.from_numpy(rng.standard_normal((6 * my, 5 * mx))),
                   ("y", "x"))
    walls = [torch.from_numpy(rng.standard_normal((my, mx, d, 5)))
             for d in (2, 1)]
    fields = [(a, 2, 1, 1, 2, *walls, ring), (a, 1, 2, 2, 0, None, None,
                                              ring),
              (a[..., :1], 2, 2, 0, 0, walls[0][..., :1], None, ring),
              (a, 0, 1, 0, 1, None, walls[1], ring)]
    for field, got in zip(fields, mesh.halos(*fields)):
        want = _two_rounds(mesh, *field)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert torch.equal(g, w)
                assert torch.equal(torch.signbit(g), torch.signbit(w))


def _lines(path):
    with open(path) as fh:
        recs = [json.loads(line) for line in fh]
    for r in recs:  # the clocks
        r.pop("step_wall_s")
        r.pop("wall_s")
    return recs


def _torchrun(args, out):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = ROOT
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "pylamp_tpu_torch", *args, "--out",
         str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _wait(proc):
    try:
        out, _ = proc.communicate(timeout=DEADLINE_S)
    finally:
        proc.kill()
    assert proc.returncode == 0, out


def test_torchrun_cli_matches_in_process(tmp_path):
    import dataclasses

    from pylamp_tpu_torch.io.checkpoint import load_checkpoint
    from pylamp_tpu_torch.models.benchmarks import falling_block
    from pylamp_tpu_torch.models.driver import run_model
    from pylamp_tpu_torch.models.setup import build

    a_out, b_out, ref_out = (tmp_path / d for d in ("a", "b", "ref"))
    args = ["run", "falling_block", "--nx", "16", "--mesh", "2x2",
            "--device", "cpu", "--checkpoint-every", "1"]
    # the 4-rank torchrun world takes step 1 while this process takes the
    # two straight steps on the in-process mesh, as the CLI builds them
    proc = _torchrun([*args, "--steps", "1"], a_out)
    cfg = falling_block(nx=16, ny=16, max_steps=2)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, explicit_halo=True, mg_coarse_replicate=16))
    run_model(cfg, out_dir=str(ref_out), checkpoint_every=1,
              dtype=torch.float32, mesh=Mesh(2, 2), device="cpu",
              shard=True)
    _wait(proc)
    _wait(_torchrun([*args, "--steps", "2", "--resume",
                     str(a_out / "checkpoint.npz")], b_out))
    ref = _lines(ref_out / "metrics.jsonl")
    got = _lines(a_out / "metrics.jsonl") + _lines(b_out / "metrics.jsonl")
    assert len(got) == 2 and got == ref
    assert all(r["mesh"] == "2x2" and r["layout"] == "sharded" for r in got)
    with np.load(b_out / "checkpoint.npz") as a, \
            np.load(ref_out / "checkpoint.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k
    _, _, template = build(cfg, dtype=torch.float32, device="cpu")
    st, _ = load_checkpoint(str(a_out / "checkpoint.npz"), template)
    assert int(st.step) == 1 and st.vx.shape == template.vx.shape


def test_torchrun_mesh_world_mismatch(tmp_path, monkeypatch):
    """A rank of a 3-rank torchrun world (its environment), before it
    joins the group: the mesh needs 4."""
    from pylamp_tpu_torch.cli import main

    for k, v in (("RANK", "0"), ("LOCAL_RANK", "0"), ("WORLD_SIZE", "3")):
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as exc:
        main(["run", "falling_block", "--nx", "16", "--steps", "2",
              "--mesh", "2x2", "--device", "cpu", "--out",
              str(tmp_path / "bad")])
    assert str(exc.value) == "--mesh 2x2: needs 4 devices, have 3"
    with pytest.raises(SystemExit, match="--mesh YxX is needed"):
        main(["run", "falling_block", "--device", "cpu"])
    assert not (tmp_path / "bad").exists()
