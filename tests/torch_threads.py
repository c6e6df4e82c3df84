"""One OpenMP thread a test process, set before PyTorch loads.

The suite runs as several processes on one machine's cores (``pytest -n
6``).  PyTorch's CPU ops default to a pool of one thread a core in every
process, so six processes oversubscribe the cores about six times over and
the port's many small ops spend their time waiting in the pool: six
processes of ``tests/test_torch_dag_exec.py``'s MobileNet-V1 tests at once
took 586 s with the default 8 threads a process and 48 s with 1, on an
8-core CPU.  Every port test module imports this one first, before
anything imports ``torch``; each ``pytest -n`` worker collects every
module, so every worker, and every thread it starts (a serving engine's
worker included), runs single-threaded.  If ``torch`` is already loaded,
nothing changes: a thread count set after the load would hold for the
calling thread alone.
"""
import os
import sys

if "torch" not in sys.modules:
    os.environ["OMP_NUM_THREADS"] = "1"
