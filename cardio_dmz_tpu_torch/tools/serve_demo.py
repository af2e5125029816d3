"""The serving loop end to end: native ingest -> the step split over a
device list -> metrics.

Simulated camera threads push frames into the C++ frame pump's ring; the
serving loop acquires latest-frame batches as page-locked host tensors,
uploads them without blocking and steps every stream's scanner session
(the PAN scan, with --expiry the date too). Each camera cycles the recorded
frames of one fixture card (cardio_dmz_tpu_torch/data/smoke_session.npz,
or expiry_session.npz with --expiry), so every accepted read can be held
against the card's number.

    python -m cardio_dmz_tpu_torch.tools.serve_demo --streams 16 --seconds 5

runs on cuda:0; --devices names other devices, comma-separated (a device
may appear twice: its shards then run one after another).
"""

import argparse
import os
import sys
import threading
import time

import numpy as np
import torch

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")


def _fixture_cards(expiry):
    """(frames (N, T, 270, 428) u8, the N cards' PANs, now) of the
    recorded sessions whose PAN the reference read."""
    name = "expiry_session.npz" if expiry else "smoke_session.npz"
    with np.load(os.path.join(_DATA, name)) as f:
        frames, now = f["frames"], tuple(f["now"].tolist())
        pans = ["".join(map(str, d[:int(n)])) for d, n in zip(
            f["completed_digits"], f["completed_n"])]
        read = np.asarray(f["number_complete"], bool)
    return frames[read], [p for p, ok in zip(pans, read) if ok], now


def main(argv=None):
    """Run the loop; prints each accepted read and the metrics text.
    Returns the counts: the metrics snapshot plus "streams", "completed"
    and "pans" (per stream, the read number or None) and "truth"."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--expiry", action="store_true")
    ap.add_argument("--devices", default="cuda:0",
                    help="comma-separated devices to split the streams over")
    args = ap.parse_args(argv)

    from ..models.weights import load_all_params
    from ..parallel.mesh import make_mesh
    from ..parallel.streams import make_sharded_step
    from ..runtime import FramePump, Metrics

    mesh = make_mesh(args.devices.split(","))
    devices = mesh.data_devices
    cards, truth, now = _fixture_cards(args.expiry)
    truth = [truth[s % len(cards)] for s in range(args.streams)]

    params = load_all_params(devices[0])
    step, place, init = make_sharded_step(params, mesh,
                                          scan_expiry=args.expiry)
    # warm up before the serving window opens: the first step builds the
    # kernels and the per-device tables
    step(init(args.streams, now), place(torch.zeros(
        (args.streams, 270, 428), dtype=torch.uint8)))
    states = init(args.streams, now)
    pump = FramePump(args.streams, frame_shape=(270, 428), device=devices)

    stop = threading.Event()

    def camera(sid):
        frames = cards[sid % len(cards)]
        i = 0
        while not stop.is_set():
            pump.push(sid, frames[i % len(frames)], frame_id=i + 1)
            i += 1
            time.sleep(1.0 / args.fps)

    threads = [threading.Thread(target=camera, args=(s,), daemon=True)
               for s in range(args.streams)]
    for t in threads:
        t.start()

    metrics = Metrics()
    metrics.set("streams", args.streams)
    got = [None] * args.streams
    deadline = time.time() + args.seconds
    try:
        while time.time() < deadline:
            with metrics.time("acquire"):
                batch, _ids, fresh = pump.acquire_batch()
            metrics.inc("frames_fresh", fresh)
            metrics.inc("frames_stale", args.streams - fresh)
            with metrics.time("step"):
                shards = place(batch)
                pump.fence()
                states, (frames, results) = step(states, shards)
                complete = results.complete.cpu().numpy()
            metrics.inc("steps")
            metrics.inc("frames_scanned", args.streams)
            metrics.inc("frames_usable", int(frames.usable.sum()))
            digits = results.predictions.cpu().numpy()
            n = results.n_numbers.cpu().numpy()
            for s in np.nonzero(complete)[0]:
                if got[s] is None:
                    got[s] = "".join(map(str, digits[s][:n[s]]))
                    ok = got[s] == truth[s]
                    metrics.inc("reads_accepted")
                    metrics.inc("reads_correct" if ok else "reads_mismatched")
                    print(f"stream {s}: {'OK ' if ok else 'MISMATCH'} "
                          f"{got[s]} (truth {truth[s]})")
            metrics.set("streams_completed",
                        sum(g is not None for g in got))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=2)
        pump.close()
    counts = metrics.snapshot()
    completed = sum(g is not None for g in got)
    print(f"{counts.get('counter_steps', 0)} serving steps, "
          f"{completed}/{args.streams} streams completed in "
          f"{args.seconds}s on {[str(d) for d in devices]}")
    print("--- metrics ---")
    print(metrics.render_text(), end="")
    counts.update(streams=args.streams, completed=completed, pans=got,
                  truth=truth)
    return counts


if __name__ == "__main__":
    main()
    sys.exit(0)
