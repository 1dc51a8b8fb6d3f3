"""Subprocess entry point for ``test_multiprocess.py``: one process of a
2-process ``jax.distributed`` cluster on the virtual CPU backend.

Run as::

    python tests/_mp_worker.py <coordinator> <num_processes> <process_id> \
        <mvt_path> <out_json> <local_devices>

Each process owns ``local_devices`` virtual CPU devices, loads ONLY its
own rows of the shared MVT file (``load_space_sharded`` skips devices
whose ``process_index`` differs), runs one global sharded search, and
dumps its replicated result to ``out_json`` for the parent to compare
against the oracle and across processes.
"""

import json
import os
import re
import sys


def main() -> None:
    coord, nproc, pid, path, out, ndev = sys.argv[1:7]
    nproc, pid, ndev = int(nproc), int(pid), int(ndev)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)

    # Pin this process to `ndev` virtual CPU devices, replacing any count
    # inherited from the parent pytest env (which uses 8).
    flags = os.environ.get("XLA_FLAGS", "")
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "", flags)
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={ndev}"
    ).strip()

    import jax

    # The config update (post-import, pre-backend-init) reliably pins to
    # CPU even where a GPU plugin is installed (see conftest).
    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from metrovector_tpu import Reader
    from metrovector_tpu.parallel import distributed as dist

    dist.initialize(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == ndev * nproc, jax.device_count()
    assert len(jax.local_devices()) == ndev

    searcher = dist.DistributedSearcher(Reader.open(path).vector_space("v"))
    # Per-host slice ownership: this process holds exactly its own devices'
    # shards — rows owned by the other process were never device_put here.
    owned = {s.device for s in searcher.data.addressable_shards}
    assert owned == set(jax.local_devices()), owned

    # Same seed as the parent's oracle — every process issues the same batch.
    rng = np.random.default_rng(7)
    queries = rng.standard_normal((5, 24)).astype(np.float32)
    res = searcher.search(queries, k=9)
    with open(out, "w") as f:
        json.dump(
            {
                "process_index": int(jax.process_index()),
                "indices": np.asarray(res.indices).tolist(),
                "distances": np.asarray(res.distances).tolist(),
            },
            f,
        )
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
