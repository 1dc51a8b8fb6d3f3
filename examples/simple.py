"""Build → save → reopen → search, end to end.

Python analog of the reference's ``examples/simple.rs`` (build a space,
save, reopen, iterate, linear-scan nearest neighbor — ``simple.rs:74-103``
in thegenem0/metrovector), with the scan replaced by the accelerator engine.

Run:  python examples/simple.py
"""

import os
import tempfile

import numpy as np

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import metrovector_tpu as mvt


def main():
    rng = np.random.default_rng(42)
    docs = rng.standard_normal((1000, 64)).astype(np.float32)

    # -- build & save -------------------------------------------------------
    builder = mvt.Builder()
    builder.add_vector_space(
        "documents", dim=64, metric=mvt.DistanceMetric.L2,
        dtype=mvt.DataType.FLOAT32,
    )
    builder.add_vectors("documents", docs)
    builder.add_metadata_column(
        "documents", "title", [f"doc-{i:04d}" for i in range(1000)]
    )
    path = os.path.join(tempfile.mkdtemp(), "documents.mvt")
    builder.build().save(path)
    print(f"wrote {path} ({os.path.getsize(path):,} bytes)")

    # -- reopen & inspect ---------------------------------------------------
    reader = mvt.Reader.open(path)
    reader.validate_with_checksum()
    print(f"spaces: {reader.vector_space_names}, version {reader.version}")
    space = reader.vector_space("documents")
    print(f"{space.num_vectors} vectors, dim {space.dim}, {space.dtype.name}")

    v = space.get_vector(0)
    print(f"vector 0, first 4 dims: {v.as_f32()[:4]}")

    # -- nearest neighbors --------------------------------------------------
    engine = mvt.SearchEngine(space)
    query = docs[123] + 0.05 * rng.standard_normal(64).astype(np.float32)
    result = engine.search(query, k=5)
    titles = space.metadata_column("title")
    print("top-5 neighbors of a noisy copy of doc-0123:")
    for idx, dist in result.top(0):
        print(f"  {titles[idx]}  L2={dist:.4f}")


if __name__ == "__main__":
    main()
