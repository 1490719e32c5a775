"""One rank of the sharded cell at a test size on the CPU (gloo), with the
exchange between ranks left out: the film's all-gather returns this rank's
band and zeros elsewhere. Run by test_bench_faults.py, one process a rank:

    python exchange_fault.py RANK WORLD PORT FAULT(0|1) BENCHMARK_JSON
"""

import json
import os
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402

TINY = dict(width=16, height=16, spp=4, chunk_spp=4, lanes=256, warmup_spp=1,
            check={"kind": "pixels", "units": 1, "pixels": 32, "limits": {"pixel_gap": 1e-3}})


def main():
    rank, world, port, fault = (int(a) for a in sys.argv[1:5])
    bench_path = sys.argv[5]
    if fault:
        from pathtrace_tpu_torch.parallel import mesh

        def no_exchange(film, camera, m):
            full = torch.zeros((m.world_size,) + tuple(film.shape), dtype=film.dtype)
            full[m.rank] = film
            return full.reshape(camera.height, camera.width, 3)

        mesh._gather_image = no_exchange
    out = harness.run("cornell.refjob4", 3000000031, 0.01, False, t_start=T0, device="cpu",
                      rank=rank, world=world, port=port, traffic_overrides=TINY,
                      bench_path=bench_path)
    if out is not None:
        print(json.dumps(out[0]))


if __name__ == "__main__":
    main()
