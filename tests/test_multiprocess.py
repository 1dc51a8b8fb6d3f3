"""A REAL process boundary: 2 ``jax.distributed`` processes × 4 virtual
CPU devices each, coordinated over localhost.

This is the one seam the single-process virtual mesh cannot exercise
(SURVEY.md §5 "multi-host via jax.distributed", §7 step 4): the
coordinator handshake, per-process slice ownership in
``load_space_sharded`` (``dev.process_index != jax.process_index()``),
global array assembly from host-local shards, and cross-process result
agreement. Reference analog: none — the reference is single-process by
construction (SURVEY.md §5).

Workers run in subprocesses (``tests/_mp_worker.py``) because a
jax.distributed cluster needs each participant to configure its backend
before first use — the pytest process already initialized its own
8-device CPU backend.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from metrovector_tpu import Builder, DistanceMetric, Reader
from metrovector_tpu.ops import numpy_oracle

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_search_matches_oracle(tmp_path, rng):
    data = rng.standard_normal((900, 24)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=24)
    b.add_vectors("v", data)
    b.delete_vector("v", 77)  # tombstone mask crosses the boundary too
    path = tmp_path / "mp.mvt"
    b.build().save(path)

    coord = f"127.0.0.1:{_free_port()}"
    nproc, ndev = 2, 4
    outs = [tmp_path / f"out{i}.json" for i in range(nproc)]
    env = dict(os.environ)
    # The worker re-pins the device count itself; just make sure nothing
    # in the parent's env wins the race before it does.
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, coord, str(nproc), str(i),
             str(path), str(outs[i]), str(ndev)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(nproc)
    ]
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        logs.append(out.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i]}"

    results = [json.loads(o.read_text()) for o in outs]
    assert sorted(r["process_index"] for r in results) == [0, 1]

    # every process computed the same replicated global result
    np.testing.assert_array_equal(results[0]["indices"], results[1]["indices"])
    np.testing.assert_allclose(
        results[0]["distances"], results[1]["distances"], rtol=1e-5
    )

    # and that result is the exact global answer
    queries = np.random.default_rng(7).standard_normal((5, 24)).astype(
        np.float32
    )
    mask = np.ones(900, np.float32)
    mask[77] = 0
    _, oi = numpy_oracle(queries, data, 9, DistanceMetric.L2, valid_mask=mask)
    got = np.asarray(results[0]["indices"])
    assert np.array_equal(got, oi)
    assert 77 not in got
