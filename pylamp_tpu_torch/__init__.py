"""pylamp_tpu_torch — the PyTorch/CUDA port of the JAX package
``pylamp_tpu``.

The JAX package ``pylamp_tpu`` is the reference; this package mirrors its
layout and names module for module (``core``, ``physics``, ``ops``,
``solvers``, ``markers``, ``models``) and is tested against it.  It imports
``torch`` and numpy, never ``jax``.

Every Pallas TPU kernel on the ported path is a hand-written CUDA C++
kernel for Hopper (``sm_90a``) under ``csrc/``, built at first use with
``nvcc`` into one shared library with a plain C interface
(``cuda_build.py``) and bound with ``ctypes``.  Each kernel wrapper runs
its plain PyTorch version on CPU tensors and launches the kernel (or
raises) on CUDA tensors.

Ported so far: the single-device bucket-engine timestep of the
Frank-Kamenetskii benchmark (``models.benchmarks.fk_bench_config``), of
the sticky-air free surface (``models.benchmarks.
sticky_air_bench_config``: augmented Lagrangian, inner velocity FGMRES,
power-iteration bounds, MG eta cap) and of the falling block with
periodic side walls (``models.benchmarks.falling_block_periodic_config``:
the periodic forms of six kernels), the first two also domain-decomposed
on the reference's explicit-halo path over a mesh (``parallel/``: every
shard on one card in-process, or one shard per rank of a torch.distributed
world, with the five per-shard kernels; non-periodic); and stretched grids on one device
(``models.benchmarks.fk_stretched_bench_config``: variable-spacing
operators, semicoarsened MG with power-iteration bounds, the Jacobi and
line smoothers, the windowed-locate marker engine; tensor code, as every
kernel's gate fails there in the reference too).  Batched parameter
sweeps (``models/sweep.py``) run their members in turn, each equal to its
solo step.

A model run starts as the reference's does, ``python -m pylamp_tpu_torch
run <model>`` (``cli.py``; on the card unless ``--device cpu`` is given):
the time loop of ``models/driver.py`` writes ``metrics.jsonl``, field
dumps, figures and checkpoints (``io/``) in the reference's formats, and
resumes bit for bit from a checkpoint written by either package; ``run
--scan N`` runs N steps per chunk, equal bit for bit to the per-step run.
"""

__version__ = "0.1.0"
