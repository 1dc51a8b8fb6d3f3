"""Element types and access modes.

Python analog of the reference's ``examples/data_types.rs`` (as_f32 /
as_bytes / as_slice access modes plus summary stats —
``data_types.rs:54-69`` in thegenem0/metrovector), extended with the accelerator
build's bfloat16 and quantized int8 spaces.

Run:  python examples/data_types.py
"""

import os
import tempfile

import numpy as np

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import metrovector_tpu as mvt


def main():
    rng = np.random.default_rng(0)
    base = rng.standard_normal((100, 32)).astype(np.float32)

    b = mvt.Builder()
    b.add_vector_space("f32", dim=32, dtype=mvt.DataType.FLOAT32)
    b.add_vector_space("f16", dim=32, dtype=mvt.DataType.FLOAT16)
    b.add_vector_space("bf16", dim=32, dtype=mvt.DataType.BFLOAT16)
    b.add_vector_space("i8", dim=32, dtype=mvt.DataType.INT8)
    for name in ("f32", "f16", "bf16", "i8"):
        b.add_vectors(name, base)  # auto-casts / auto-quantizes per space
    path = os.path.join(tempfile.mkdtemp(), "types.mvt")
    b.build().save(path)

    r = mvt.Reader.open(path)
    for name in r.vector_space_names:
        sp = r.vector_space(name)
        v = sp.get_vector(7)
        as_f32 = v.as_f32()
        raw = v.as_bytes()
        print(f"space {name:>5}: dtype={sp.dtype.name:<9} "
              f"elem bytes={len(raw) // sp.dim}  "
              f"sum={as_f32.sum():8.3f}  mean={as_f32.mean():7.4f}  "
              f"l2={np.linalg.norm(as_f32):7.4f}")
        if sp.quantization:
            q = sp.quantization
            deq = v.dequantized(q.scale, q.zero_point)
            err = np.abs(deq - base[7]).max()
            print(f"        quantized: scale={q.scale:.5f} "
                  f"zero_point={q.zero_point:.2f} max dequant err={err:.5f}")

    # zero-copy reinterpretation (reference Vector::as_slice / cast_to)
    sp = r.vector_space("f32")
    v = sp.get_vector(0)
    print("reinterpret f32 row as u8:", v.as_slice(np.uint8)[:8], "...")
    print("reinterpret f32 row as i32:", v.cast_to(np.int32)[:4], "...")


if __name__ == "__main__":
    main()
