"""A world of ``torch.distributed`` ranks for the port's tests.

``spawn`` runs a test file as a script, one process per rank (its
``__main__`` calls the file's worker with ``worker rank world init
out_dir`` and any extra arguments), rendezvous through a file under
``out_dir``; each rank saves its arrays (``rank<r>.npz``) and, if it
has one, a JSON record (``rank<r>.json``), as :func:`save` does, and
``spawn`` returns them in rank order (None for a missing record).  A
rank that fails or outlives ``JOIN_SECONDS`` fails the caller (the
others are killed).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

JOIN_SECONDS = 240


def spawn(script, world, out_dir, *extra):
    os.makedirs(out_dir, exist_ok=True)
    init = "file://" + os.path.join(out_dir, "rendezvous")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, script, "worker", str(r), str(world), init,
         out_dir, *extra], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_SECONDS)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"world {world}: a rank hung past {JOIN_SECONDS} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world}:\n{log[-4000:]}"
    out = []
    for r in range(world):
        data = np.load(os.path.join(out_dir, f"rank{r}.npz"))
        record = os.path.join(out_dir, f"rank{r}.json")
        if os.path.exists(record):
            with open(record) as f:
                record = json.load(f)
        else:
            record = None
        out.append(({k: data[k] for k in data.files}, record))
    return out


def join(rank, world, init):
    """This process's rank of a gloo world (one thread)."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    return dist


def save(out_dir, rank, arrays, record):
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)


def session_file(tmp_path_factory, name, make):
    """The path of a file made once a test session, whichever xdist
    worker asks first: ``make(path)`` writes it under a lock in the
    session's shared base temp dir, and later callers (other workers
    too) read the same file."""
    import fcntl
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent          # every worker's basetemp's parent
    path = os.path.join(str(base), name)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            tmp = os.path.join(str(base), "tmp-" + name)
            make(tmp)
            os.replace(tmp, path)
    return path


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread for a module that imports this fixture:
    the port's test ops are small, and beside the suite's other workers
    (a pool of one thread a core each) they crawl."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
