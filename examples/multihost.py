"""Multi-HOST distributed search: a 2-process ``jax.distributed`` cluster
on one machine (each process simulating one host with its own devices).

No reference analog exists — the reference is a single-process mmap
library (SURVEY.md §5). On a real cluster each host runs this same
program (one process per host, same coordinator address); here the two
"hosts" are subprocesses with virtual CPU devices so the full flow —
coordinator handshake, per-host slice loading (each process ``device_put``s
ONLY the rows its own devices shard), global sharded search, replicated
result — runs anywhere:

    python examples/multihost.py

Worker flow (``--worker``):
  1. ``parallel.distributed.initialize(coordinator_address=..., ...)``
  2. ``DistributedSearcher(space)`` — loads this host's slice only
  3. ``searcher.search(queries, k)`` — one global search; every process
     gets the same replicated result.
"""

import json
import os
import re
import socket
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N, DIM, K, NDEV = 50_000, 64, 5, 2  # NDEV virtual devices per "host"


def worker(coord: str, pid: int, path: str, out_path: str) -> None:
    flags = re.sub(
        r"--xla_force_host_platform_device_count=\d+",
        "",
        os.environ.get("XLA_FLAGS", ""),
    )
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={NDEV}"
    ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from metrovector_tpu import Reader
    from metrovector_tpu.parallel import distributed as dist

    dist.initialize(
        coordinator_address=coord, num_processes=2, process_id=pid
    )
    searcher = dist.DistributedSearcher(
        Reader.open(path).vector_space("corpus")
    )
    owned = sorted(
        int(s.index[0].start or 0)
        for s in searcher.data.addressable_shards
    )
    print(
        f"[host {jax.process_index()}] {len(jax.local_devices())} local "
        f"devices, shard row starts {owned}",
        flush=True,
    )
    queries = np.random.default_rng(7).standard_normal((4, DIM)).astype(
        np.float32
    )
    res = searcher.search(queries, k=K)
    with open(out_path, "w") as f:
        json.dump(np.asarray(res.indices).tolist(), f)
    jax.distributed.shutdown()


def main() -> None:
    import numpy as np

    import metrovector_tpu as mvt

    rng = np.random.default_rng(0)
    data = rng.standard_normal((N, DIM)).astype(np.float32)
    b = mvt.Builder()
    b.add_vector_space("corpus", dim=DIM)
    b.add_vectors("corpus", data)
    path = os.path.join(tempfile.mkdtemp(), "corpus.mvt")
    b.build().save(path)
    print(f"built {N}x{DIM} corpus -> {path}")

    with socket.socket() as s:  # free port for the coordinator
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"

    outs = [path + f".{i}.json" for i in range(2)]
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             coord, str(i), path, outs[i]],
            env=env,
        )
        for i in range(2)
    ]
    for p in procs:
        assert p.wait(timeout=300) == 0, "worker failed"

    results = [json.load(open(o)) for o in outs]
    assert results[0] == results[1], "hosts disagreed"
    queries = np.random.default_rng(7).standard_normal((4, DIM)).astype(
        np.float32
    )
    d2 = ((queries[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    oracle = np.argsort(d2, axis=1, kind="stable")[:, :K]
    assert np.array_equal(np.asarray(results[0]), oracle), "oracle mismatch"
    print(f"both hosts returned identical, oracle-exact top-{K} ids")
    print("first query's top ids:", results[0][0])


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        main()
