"""Where kernels 2 (m2g) and 3 (advect) of the PyTorch/CUDA port spend their
time on one GPU: each probe builds an edited copy of the package with one
part of a kernel switched off, and times the kernel on the FK 1024^2 x K18
state; kernel 2 is also timed under other launch plans.

    python3 kernel_probe.py [--out FILE]

Probes (each a copy of ``pylamp_tpu_torch`` under ``_checkout/probe_*``,
which .gitignore lists, built and timed in its own process; the edits go
to the bodies that kernels 2 and 10 and kernels 3 and 11 share,
``csrc/m2g_rows.cuh`` and ``csrc/advect_tile.cuh``, and only kernels 2
and 3 are timed):

- kernel 2: ``base``; ``no_gather`` (the node threads sum nothing);
  ``no_stage`` (no staging, so no slot masks and no gather: the copies
  and the unit loop); ``no_copy_no_stage`` (the unit loop alone, with its
  barriers and output rows); ``empty`` (the kernel returns at once);
- kernel 3: ``base``; ``no_live_rk4`` (live slots store a placeholder
  instead of their RK4: the window, the scan and the empty slots);
  ``scan_only`` (empty slots store their x as is too);
- kernel 2 plans on the unedited copy: units of 9 slots (two a cell row,
  the plan's), of 18 (one) and of 6 (three), one or two threads a node,
  and chunks of 32, 22 or 16 node rows.

Every variant's device ms (one call captured in a CUDA graph and
replayed, ``chip_smoke.graph_ms``) and registers and resident blocks per
SM; edited variants compute wrong sums by design and are only timed.
Prints one JSON object (and writes it to ``--out``); exits non-zero
without a CUDA device.  A probe whose edit no longer matches the source
fails loudly.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent

# (kernel source, [(text, replacement)]) of each probe
PROBES = {
    "m2g base": ("m2g_rows.cuh", []),
    "m2g no_gather": ("m2g_rows.cuh", [(
        "            while (hits) {",
        "            hits = 0u;\n            while (hits) {")]),
    "m2g no_stage": ("m2g_rows.cuh", [(
        "    if (!exists) return;", "    return;")]),
    "m2g no_copy_no_stage": ("m2g_rows.cuh", [
        ("    if (!exists) return;", "    return;"),
        ("    if (exists) {", "    if (false) {")]),
    "m2g empty": ("m2g_rows.cuh", [(
        "    if (threadIdx.x == 0) {\n        tbl = tbl_in;",
        "    if (a.K > 0) return;\n    if (threadIdx.x == 0) {\n"
        "        tbl = tbl_in;")]),
    "advect base": ("advect_tile.cuh", []),
    "advect no_live_rk4": ("advect_tile.cuh", [(
        "            rk4_marker<P>(list_x[i], list_y[i], cj0 + r, ci0 + c, dt,\n"
        "                          vxl, vyl, a.dx, a.dy, a.inv_dx, a.inv_dy, a.x_lo,\n"
        "                          a.x_hi, a.y_lo, a.y_hi, a.reach, a.out_x[q],\n"
        "                          a.out_y[q], a.lx, a.inv_lx);",
        "            a.out_x[q] = list_x[i] + list_y[i];")]),
}
PROBES["advect scan_only"] = ("advect_tile.cuh", PROBES["advect no_live_rk4"][1] + [(
    "                if (!live)\n"
    "                    rk4_empty<P>(px, py, dt, a.x_lo, a.x_hi, a.y_lo, a.y_hi,\n"
    "                                 a.out_x[q], a.out_y[q], a.lx, a.inv_lx);",
    "                if (!live) a.out_x[q] = px;")])
# kernel 2 plans: (slots a unit, units a cell row, threads a node, rows)
PLANS = [(9, 2, 2, 32), (18, 1, 2, 32), (6, 3, 2, 32), (18, 1, 1, 32),
         (9, 2, 1, 32), (9, 2, 2, 22), (9, 2, 2, 16)]


def child(tree: str, name: str):
    """Time one probe from the package copy at ``tree`` (a process of its
    own, so that each copy's library is the one loaded)."""
    import torch

    import chip_smoke as cs  # (puts this file's directory on sys.path)
    sys.path.insert(0, tree)
    from pylamp_tpu_torch import cuda_build
    from pylamp_tpu_torch.markers.kernels import advect, m2g
    from pylamp_tpu_torch.models.benchmarks import fk_bench_config
    from pylamp_tpu_torch.models.setup import build
    from pylamp_tpu_torch.models.step import make_step_phases

    cuda_build.build()
    cuda_build.library()
    cfg = fk_bench_config(cs.FK_NX)
    grid, table, st = build(cfg, dtype=torch.float32, device="cuda")
    bm, phys = st.markers, cfg.physics
    out = {}
    if name.startswith("m2g"):
        plans = PLANS if name == "m2g base" else PLANS[:1]
        for kc, units, split, rows in plans:
            plan = m2g.M2GPlan(32, rows, kc, units, split,
                               -(-(grid.nx + 1) // 32),
                               -(-(grid.ny + 1) // rows),
                               m2g.smem_bytes(32, kc))
            m2g.m2g_plan = lambda *a, plan=plan: plan
            fn = lambda: m2g.m2g_fused_cuda(bm, grid, table, phys,  # noqa: E731
                                            with_energy=True)
            info = m2g.kernel_info(plan, m2g.FLAG_ENERGY)
            out[f"units {kc}x{units}, {split} a node, rows {rows}"] = dict(
                device_ms=cs.graph_ms(fn), registers=info["registers"],
                blocks_per_sm=info["blocks_per_sm"])
    else:
        ph = make_step_phases(grid, cfg, table)
        io = ph.interp(st)
        vx, vy, _, _ = ph.stokes(st, io)
        dt = ph.timestep(vx, vy, io.k_m, io.rhocp_m)
        vbc = cfg.physics.velocity_bcs
        fn = lambda: advect.advect_rk4_cuda(bm, vx, vy, dt, grid, vbc, 1)  # noqa: E731
        info = advect.kernel_info(advect.advect_plan(*bm.x.shape))
        out["plan"] = dict(device_ms=cs.graph_ms(fn),
                           registers=info["registers"],
                           blocks_per_sm=info["blocks_per_sm"])
    print(json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_probe: no CUDA device")
    import chip_smoke as cs
    rec = {"device": cs.nvidia_smi_line(), "probes": {}}
    for name, (source, edits) in PROBES.items():
        tree = ROOT / "_checkout" / ("probe_" + name.replace(" ", "_"))
        if tree.exists():
            shutil.rmtree(tree)
        shutil.copytree(ROOT / "pylamp_tpu_torch", tree / "pylamp_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        path = tree / "pylamp_tpu_torch" / "csrc" / source
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"kernel_probe: probe {name!r} no longer "
                                 f"matches csrc/{source}")
            text = text.replace(old, new)
        path.write_text(text)
        run = subprocess.run([sys.executable, __file__, "--child", str(tree),
                              name], capture_output=True, text=True,
                             check=True)
        rec["probes"][name] = json.loads(run.stdout.strip().splitlines()[-1])
        cs.log(name, json.dumps(rec["probes"][name]))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec))


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3])
    else:
        main()
