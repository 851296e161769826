"""Launcher for the port's multi-process tests: ``run_ranks(job, world,
tmp_path, *args)`` spawns ``world`` processes (``torch.multiprocessing``
spawn), joins them in one ``gloo`` process group over a ``FileStore`` in
``tmp_path`` (no ports, so workers of ``pytest -n`` cannot clash), runs
``job(rank, world, *args)`` in each with one intra-op thread and returns
the ranks' results (numpy trees, pickled through ``tmp_path``).  A rank
that raises fails the run with its traceback.  ``start_ranks`` does the
same without waiting, so a test's fixture computes its expectations while
the ranks run.

The jobs live in ``_torch_dist_jobs.py``, which imports the port and
numpy only: a spawned rank imports the job's module, and the reference
(jax) stays out of the ranks.
"""
import os
import pickle
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, store_path, out_dir, job, args):
    torch.set_num_threads(1)
    out = os.path.join(out_dir, f"rank{rank}.pkl")
    os.environ["REPRO_RANK_LOG"] = os.path.join(out_dir, f"rank{rank}.log")
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world)
        try:
            res = ("ok", job(rank, world, *args))
            # leave together: a rank that closes its gloo pairs while a
            # peer still reads from them fails the peer's collectives with
            # "connection closed by peer"
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except Exception:
        res = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(res, f)
    if res[0] == "error":
        raise SystemExit(1)


def run_ranks(job, world, tmp_path, *args):
    """[job(0, world, *args), ..., job(world - 1, world, *args)]."""
    return start_ranks(job, world, tmp_path, *args)()


def start_ranks(job, world, tmp_path, *args):
    """Spawn the ranks and return at once: calling the result waits for
    them and returns ``run_ranks``'s list (the caller works meanwhile)."""
    out_dir = os.path.join(str(tmp_path), f"ranks_{job.__name__}")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    ctx = mp.start_processes(_entry, args=(world, store, out_dir, job, args),
                             nprocs=world, join=False, start_method="spawn")

    def wait(timeout=600):
        deadline = time.monotonic() + timeout
        ended = ""
        try:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    for proc in ctx.processes:
                        proc.terminate()
                    raise TimeoutError(f"{job.__name__}: ranks still "
                                       f"running after {timeout} s; last "
                                       f"steps: {_progress(out_dir, world)}")
        except TimeoutError:
            raise
        except Exception as e:
            # a rank ended with an error or a signal (torch then stops the
            # others); its traceback, if it wrote one, is in its file
            ended = f" ({e}; last steps: {_progress(out_dir, world)})"
        return _results(job, world, out_dir, ended)
    return wait


def progress(step):
    """Note ``step`` in this rank's progress file (read back when the ranks
    time out)."""
    path = os.environ.get("REPRO_RANK_LOG")
    if path:
        with open(path, "a") as f:
            f.write(f"{step}\n")


def _progress(out_dir, world):
    last = {}
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.log")
        if os.path.exists(path):
            with open(path) as f:
                lines = f.read().split()
            last[r] = lines[-1] if lines else None
    return last


def _results(job, world, out_dir, ended=""):
    results = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.pkl")
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} of {job.__name__} left no "
                               f"result{ended}")
        with open(path, "rb") as f:
            status, val = pickle.load(f)
        if status != "ok":
            raise RuntimeError(f"rank {r} of {job.__name__} failed"
                               f"{ended}:\n{val}")
        results.append(val)
    return results
