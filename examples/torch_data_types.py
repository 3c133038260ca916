"""Element types and access modes, searched on the PyTorch + CUDA port.

The counterpart of ``examples/data_types.py``: the same four spaces (f32,
f16, bf16 and quantized int8) with the same printed access modes and
summary statistics, then each space searched by
``metrovector_tpu_torch.SearchEngine`` on the card, where the f32, f16 and
bf16 spaces run K1's FFMA scan and the int8 space its integer scan
(``--device cpu`` runs their plain versions).

Run:  python examples/torch_data_types.py [--device cuda|cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import metrovector_tpu_torch as mvt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    base = rng.standard_normal((100, 32)).astype(np.float32)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        b = mvt.Builder()
        b.add_vector_space("f32", dim=32, dtype=mvt.DataType.FLOAT32)
        b.add_vector_space("f16", dim=32, dtype=mvt.DataType.FLOAT16)
        b.add_vector_space("bf16", dim=32, dtype=mvt.DataType.BFLOAT16)
        b.add_vector_space("i8", dim=32, dtype=mvt.DataType.INT8)
        for name in ("f32", "f16", "bf16", "i8"):
            b.add_vectors(name, base)  # auto-casts / auto-quantizes per space
        path = os.path.join(tmp, "types.mvt")
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

        # every element type through the device's exact search
        for name in r.vector_space_names:
            res = mvt.SearchEngine(r.vector_space(name), device=args.device).search(
                base[7:9], k=3)
            print(f"search {name:>5}: top-3 of rows 7, 8 -> {res.indices.tolist()}")
            out[name] = {"indices": res.indices, "scores": res.scores}
    return out


if __name__ == "__main__":
    main()
