"""The GCS plugin's whole pipeline against a local fake server with
injected per-request latency.

Counterpart of benchmarks/gcs_pipeline/main.py. It measures the part of
cloud throughput the framework controls, how many requests the pipeline
keeps in flight, against the fake GCS server of the plugin's tests
(``_fake_gcs.py``), with a fixed latency added to EVERY request (the
cloud's round trip; loopback bandwidth is effectively unlimited, so
hiding latency is the whole game, as against a real bucket).

Reported per phase (take, restore): wall seconds and GB/s through the
whole pipeline (slab batching, resumable-upload chunking, ranged
downloads); the requests issued and their serial floor (requests x
latency); concurrency = serial floor / wall. The restore (in place, onto
the device) must equal the state.

    python -m tpusnap_torch.benchmarks.gcs_pipeline [--latency-ms 100]
        [--total-mb 256] [--upload-chunk-mb 8] [--device cuda|cpu]
"""

import argparse
import sys
import threading
import time
from http.server import ThreadingHTTPServer
from typing import List, Optional

import torch

import tpusnap_torch.storage_plugins.gcs as gcs_mod
from tpusnap_torch import PytreeState, Snapshot
from tpusnap_torch._device import add_device_argument, device_missing
from tpusnap_torch.benchmarks import result, synchronize
from tpusnap_torch.benchmarks._fake_gcs import FakeGCS, _make_handler
from tpusnap_torch.knobs import override_slab_size_threshold_bytes


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="tpusnap_torch.benchmarks.gcs_pipeline")
    parser.add_argument("--latency-ms", type=float, default=100.0)
    parser.add_argument("--total-mb", type=int, default=256)
    parser.add_argument(
        "--upload-chunk-mb", type=int, default=8,
        help="resumable-upload chunk size (production default is 100 MB; smaller "
        "here so a modest state still exercises multi-chunk sessions)",
    )
    add_device_argument(parser)
    args = parser.parse_args(argv)
    if device_missing(parser.prog, args.device):
        return 2

    server_state = FakeGCS()
    server = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(server_state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    opts = {"api_endpoint": f"http://127.0.0.1:{server.server_address[1]}",
            "deadline_sec": 120.0}
    chunk = args.upload_chunk_mb << 20
    prev = gcs_mod._UPLOAD_CHUNK_SIZE, gcs_mod._DOWNLOAD_CHUNK_SIZE
    gcs_mod._UPLOAD_CHUNK_SIZE = gcs_mod._DOWNLOAD_CHUNK_SIZE = chunk

    total = args.total_mb << 20
    gen = torch.Generator(device=args.device).manual_seed(0)
    u8 = lambda n: torch.randint(0, 255, (n,), generator=gen, dtype=torch.uint8,  # noqa: E731
                                 device=args.device)
    # A train state's shape census: a few large tensors (multi-chunk
    # resumable sessions) and many small ones (batched into a handful of
    # slab uploads).
    state = {**{f"big{i}": u8(total // 8) for i in range(6)},
             **{f"small{i}": u8(64 << 10) for i in range(64)}}
    nbytes = sum(t.numel() for t in state.values())
    lat = args.latency_ms / 1e3
    phases = {}

    def phase(name, fn):
        server_state.request_log.clear()
        synchronize(args.device)
        t0 = time.perf_counter()
        fn()
        synchronize(args.device)
        wall = time.perf_counter() - t0
        reqs = len(server_state.request_log)
        floor = reqs * lat
        print(f"{name:8s} {wall:6.2f}s  {nbytes / wall / 1e9:5.2f} GB/s  {reqs:4d} requests, "
              f"serial latency floor {floor:6.2f}s -> concurrency {floor / wall:4.1f}x")
        phases[name] = {"seconds": wall, "gb_s": nbytes / wall / 1e9, "requests": reqs,
                        "serial_floor_s": floor, "concurrency": floor / wall}

    try:
        print(f"state: {nbytes / 1e6:.0f} MB (6 large + 64 small tensors), latency "
              f"{args.latency_ms:.0f} ms/request, upload/download chunk "
              f"{args.upload_chunk_mb} MB")
        server_state.latency_s = lat
        # A 2 MB slab threshold (production 128 MB): the large tensors are
        # standalone objects whose sessions upload in parallel.
        target = PytreeState({k: torch.zeros_like(v) for k, v in state.items()})
        with override_slab_size_threshold_bytes(2 << 20):
            phase("take", lambda: Snapshot.take(
                "gs://bkt/snap", {"m": PytreeState(state)}, storage_options=opts))
            phase("restore", lambda: Snapshot("gs://bkt/snap", storage_options=opts).restore(
                {"m": target}))
        ok = all(torch.equal(target.tree[k], v) for k, v in state.items())
        print(f"restore verified: {ok}")
    finally:
        gcs_mod._UPLOAD_CHUNK_SIZE, gcs_mod._DOWNLOAD_CHUNK_SIZE = prev
        server.shutdown()
        thread.join(timeout=5)
    return result("gcs_pipeline", args.device, ok, bytes=nbytes, latency_ms=args.latency_ms,
                  upload_chunk_mb=args.upload_chunk_mb, restore_verified=ok, **phases)


if __name__ == "__main__":
    sys.exit(main())
