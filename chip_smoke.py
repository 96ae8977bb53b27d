"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on a mismatch; none catches its own failure):

1. Build the CUDA kernels from ``visionworkbench_torch/csrc/`` (one nvcc per
   source, started together) and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, on inputs quantized to the 1/256 grid:
   integer disparities, validity, cost patches and keep masks must match
   exactly.
3. Run the main path — ``pyramid_correlate`` at the configuration of
   ``bench.py`` (1024^2 pair, 64x8 search, 15x15 kernel, 4 levels, tile 64,
   parabola) — then again with the L<->R check, apply ``bench.py``'s sanity
   check, and check the kernels' launch counts of each run.
4. Run the whole slice at 256^2 with 2 levels on the card and on the CPU
   (plain versions) on quantized inputs: integer disparities and validity
   must be equal, the parabola output allclose at atol 1e-4.
5. Time the frame and each kernel with CUDA events.

Prints the times on earlier lines, then one JSON line of per-kernel
numbers, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, printing no result, without a CUDA device or without the
``visionworkbench_torch`` package beside it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# Main-path configuration (bench.py:30-33).
H = W = 1024
SEARCH = (0, -4, 64, 8)      # x_min, y_min, width, height
KERNEL = (15, 15)
LEVELS = 4
TILE = 64

# Published H100 SXM peaks (NVIDIA's data sheet): HBM rate and fp32
# rate outside the tensor cores. int32 ALU work is counted at the fp32 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Least operations per pixel and candidate of a sweep with sliding window
# sums: cost (2), column running sum (2), row running sum (2); plus the
# best/worst update (2) for each searched (not ring) candidate.
SWEEP_OPS_BOX = 6
SWEEP_OPS_SELECT = 2
# Per pixel and window neighbour of the speckle stencil: two field
# extracts, two differences, two abs, two compares, an and, an add.
SPECKLE_OPS = 10


def _make_pair(h, w):
    """bench.py's pair: left(p) == right(p + (16, 0))."""
    rng = np.random.default_rng(7)
    ys, xs = np.mgrid[0:h, 0:w + 80].astype(np.float32)
    tex = (np.sin(xs * 0.21) * np.cos(ys * 0.17)
           + 0.5 * np.sin(xs * 0.047 + ys * 0.031)
           + 0.3 * rng.random(xs.shape)).astype(np.float32)
    return tex[:, 16:16 + w], tex[:, :w]


def _quantized(rng, shape):
    return (rng.integers(0, 256, shape) / 256.0).astype(np.float32)


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---- phase 1 ----------------------------------------------------------------

def phase_build():
    from visionworkbench_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"[build] {len(libs)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


# ---- phase 2 ----------------------------------------------------------------

def sweep_cases():
    """The sweep's shapes on the main path: level 0 with the patch ring,
    the level-0 R->L pass, and level 2."""
    kw, kh = KERNEL
    cases = []
    for name, level, ring, rl in (("level0_patches", 0, 1, False),
                                  ("level0_rl", 0, 0, True),
                                  ("level2", 2, 0, False)):
        s = 1 << level
        s_w, s_h = max(SEARCH[2] // s, 1), max(SEARCH[3] // s, 1)
        sx, sy = min(11, s_w), min(11, s_h)
        out = -(-H // s)
        if rl:
            out = min(out + SEARCH[2], H + SEARCH[3])
        nt = -(-out // TILE)
        lb = nt * TILE + kw - 1
        if rl:      # left frame with the (S-1 + max_off) margin
            mh = lb + (sy - 1) + (sy - 1 + s_h - sy)
            mw = lb + (sx - 1) + (sx - 1 + s_w - sx)
        else:
            mh = lb + s_h - 1 + 2 * ring
            mw = lb + s_w - 1 + 2 * ring
        cases.append(dict(name=name, nt=nt, lb=lb, mh=mh, mw=mw, sx=sx, sy=sy,
                          max_off=(s_w - sx, s_h - sy), ring=ring))
    return cases


def _sweep_inputs(case, dev, seed):
    import torch
    rng = np.random.default_rng(seed)
    base = _quantized(rng, (case["lb"], case["lb"]))
    match = _quantized(rng, (case["mh"], case["mw"]))
    # embed the left frame so the search has true winners
    match[2:2 + case["lb"], 3:3 + case["lb"]] = base[:case["mh"] - 2, :case["mw"] - 3]
    nt = case["nt"]
    offs = np.stack([rng.integers(0, case["max_off"][0] + 1, (nt, nt)),
                     rng.integers(0, case["max_off"][1] + 1, (nt, nt))], -1)
    return (torch.as_tensor(base, device=dev), torch.as_tensor(match, device=dev),
            torch.as_tensor(offs.astype(np.int32), device=dev))


def speckle_cases():
    """The speckle stencil's shapes on the main path (level 0 11x11, a
    coarse level's 3x3 second pass) and one odd frame."""
    return [dict(name="1024x1024_11x11", h=1024, w=1024, half=5, t=3, min_match=61),
            dict(name="512x512_3x3", h=512, w=512, half=1, t=3, min_match=2),
            dict(name="1000x777_11x11", h=1000, w=777, half=5, t=3, min_match=61)]


def _speckle_input(case, dev, seed):
    import torch
    from visionworkbench_torch.stereo.disparity import _pack_code
    rng = np.random.default_rng(seed)
    h, w = case["h"], case["w"]
    dx = 16 + rng.integers(-2, 3, (h, w))
    dx = np.where(rng.random((h, w)) < 0.15, rng.integers(0, 64, (h, w)), dx)
    dy = rng.integers(-1, 2, (h, w))
    disp = torch.as_tensor(np.stack([dx, dy], -1).astype(np.int32), device=dev)
    valid = torch.as_tensor(rng.random((h, w)) < 0.9, device=dev)
    return _pack_code(disp, valid)


def phase_kernels(dev):
    import torch
    from visionworkbench_torch.ops import speckle, sweep
    kw, kh = KERNEL
    err = {"sweep": 0.0, "speckle": 0.0}
    for i, c in enumerate(sweep_cases()):
        base, match, offs = _sweep_inputs(c, dev, 100 + i)
        args = (base, match, offs, TILE, c["sx"], c["sy"], kw, kh, "abs",
                bool(c["ring"]))
        d1, v1, p1 = sweep.sweep(*args)
        d0, v0, p0 = sweep.sweep_plain(*args)
        torch.cuda.synchronize()
        e = max(float((d1 - d0).abs().max()), float((v1 != v0).sum()))
        if p1 is not None:
            e = max(e, float((p1 - p0).abs().max()))
        err["sweep"] = max(err["sweep"], e)
        print(f"[kernels] sweep {c['name']}: tiles {c['nt']}x{c['nt']}, "
              f"window {c['sx']}x{c['sy']}, valid {float(v1.float().mean()):.4f}, "
              f"max_abs_err {e}")
        if e != 0.0:
            raise SystemExit(f"sweep kernel disagrees with its plain version at {c['name']}")
    for i, c in enumerate(speckle_cases()):
        code = _speckle_input(c, dev, 200 + i)
        args = (code, c["half"], c["half"], c["t"], c["min_match"])
        k1 = speckle.speckle_keep_mask(*args)
        k0 = speckle.speckle_keep_mask_plain(*args)
        torch.cuda.synchronize()
        e = float((k1 != k0).sum())
        err["speckle"] = max(err["speckle"], e)
        print(f"[kernels] speckle {c['name']}: keep {float(k1.float().mean()):.4f}, "
              f"max_abs_err {e}")
        if e != 0.0:
            raise SystemExit(f"speckle kernel disagrees with its plain version at {c['name']}")
    return err


# ---- phase 3 ----------------------------------------------------------------

def _bench_run(left, right, dev, **kw):
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.stereo.pyramid_correlation import pyramid_correlate
    return pyramid_correlate(left, right, BBox2i(*SEARCH), kernel_size=KERNEL,
                             max_pyramid_levels=LEVELS, tile_size=TILE,
                             subpixel="parabola", device=dev, **kw)


def _sanity(dm, what):
    """bench.py:104-110, plus shape and finiteness."""
    import torch
    if tuple(dm.disparity.shape) != (H, W, 2) or tuple(dm.valid.shape) != (H, W):
        raise SystemExit(f"{what}: wrong output shape {tuple(dm.disparity.shape)}")
    if not bool(torch.isfinite(dm.disparity).all()):
        raise SystemExit(f"{what}: non-finite disparities")
    d, v = dm.to_numpy()
    core = np.s_[32:-32, 32:-32]
    vc = v[core]
    frac = (np.abs(d[..., 0][core] - 16.0) < 0.5)[vc].mean() if vc.any() else 0.0
    print(f"[main] {what}: core valid {vc.mean():.4f}, within 0.5 px of 16: {frac:.4f}")
    if vc.mean() < 0.5 or frac < 0.9:
        raise SystemExit(f"{what}: sanity failed (valid {vc.mean():.3f}, correct {frac:.3f})")


def phase_main(dev):
    import torch
    from visionworkbench_torch.ops import speckle, sweep
    left, right = _make_pair(H, W)
    counts = {}
    for what, kw, want_sweeps in (("plain", {}, 5),
                                  ("consistency", {"consistency_threshold": 2.0}, 6)):
        sweep.launches = 0
        speckle.launches = 0
        dm = _bench_run(left, right, dev, **kw)
        torch.cuda.synchronize()
        counts[what] = {"sweep": sweep.launches, "speckle": speckle.launches}
        print(f"[main] {what}: launches {counts[what]}")
        _sanity(dm, what)
        if counts[what] != {"sweep": want_sweeps, "speckle": 9}:
            raise SystemExit(f"{what}: expected {want_sweeps} sweep and 9 "
                             f"speckle launches, got {counts[what]}")
    return counts


# ---- phase 4 ----------------------------------------------------------------

def phase_slice_vs_cpu(dev):
    import torch
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.stereo.pyramid_correlation import pyramid_correlate
    left, right = _make_pair(256, 256)
    left = np.round(left * 256) / 256
    right = np.round(right * 256) / 256
    for what, kw in (("integer+lr", dict(consistency_threshold=2.0)),
                     ("parabola", dict(subpixel="parabola"))):
        outs = [pyramid_correlate(left, right, BBox2i(*SEARCH), kernel_size=KERNEL,
                                  max_pyramid_levels=2, tile_size=TILE,
                                  device=d, **kw).to_numpy()
                for d in (dev, "cpu")]
        (dg, vg), (dc, vc) = outs
        if not np.array_equal(vg, vc):
            raise SystemExit(f"slice {what}: validity differs GPU vs CPU "
                             f"({int((vg != vc).sum())} pixels)")
        if what == "parabola":
            e = float(np.abs(dg - dc).max())
            ok = np.allclose(dg, dc, rtol=0, atol=1e-4)
        else:
            e = float(np.abs(dg - dc).max())
            ok = np.array_equal(dg, dc)
        print(f"[slice] {what}: valid {vg.mean():.4f}, max |gpu - cpu| {e}")
        if not ok:
            raise SystemExit(f"slice {what}: disparities differ GPU vs CPU")


# ---- phase 5 ----------------------------------------------------------------

def _time_ms(fn, reps, warmup=2):
    """Median ms of ``fn`` over ``reps`` calls, each between CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def phase_timings(dev):
    import torch
    from visionworkbench_torch.ops import speckle, sweep
    kw, kh = KERNEL
    left, right = _make_pair(H, W)
    lt = torch.as_tensor(left, device=dev)
    rt = torch.as_tensor(right, device=dev)
    frame = {}
    for what, kwargs in (("plain", {}), ("consistency", {"consistency_threshold": 2.0})):
        ms = _time_ms(lambda: _bench_run(lt, rt, dev, **kwargs), reps=10)
        frame[what] = {"ms": ms, "mps": H * W / (ms * 1e3)}
        print(f"[time] frame {what}: {ms:.4f} ms, {H * W / (ms * 1e3):.3f} Mp/s")
    _profile_frame(lt, rt, dev, frame["plain"]["ms"])
    rows = {}
    for i, c in enumerate(sweep_cases()):
        base, match, offs = _sweep_inputs(c, dev, 100 + i)
        args = (base, match, offs, TILE, c["sx"], c["sy"], kw, kh, "abs",
                bool(c["ring"]))
        ms = _time_ms(lambda: sweep.sweep(*args), reps=20)
        plain_ms = _time_ms(lambda: sweep.sweep_plain(*args), reps=3, warmup=1)
        npx = (c["nt"] * TILE) ** 2
        n_int = c["sx"] * c["sy"]
        n_ext = (c["sx"] + 2 * c["ring"]) * (c["sy"] + 2 * c["ring"])
        nbytes = 4 * (base.numel() + match.numel() + offs.numel()) + npx * (8 + 1 + 36 * c["ring"])
        ops = npx * (SWEEP_OPS_BOX * n_ext + SWEEP_OPS_SELECT * n_int)
        rows[("sweep", c["name"])] = _row(ms, plain_ms, nbytes, ops)
    for i, c in enumerate(speckle_cases()):
        code = _speckle_input(c, dev, 200 + i)
        args = (code, c["half"], c["half"], c["t"], c["min_match"])
        ms = _time_ms(lambda: speckle.speckle_keep_mask(*args), reps=20)
        plain_ms = _time_ms(lambda: speckle.speckle_keep_mask_plain(*args), reps=3, warmup=1)
        npx = c["h"] * c["w"]
        ops = npx * (2 * c["half"] + 1) ** 2 * SPECKLE_OPS
        rows[("speckle", c["name"])] = _row(ms, plain_ms, 8 * npx, ops)
    for (k, name), r in rows.items():
        print(f"[time] {k} {name}: {r['ms']:.4f} ms per launch, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']})")
    return frame, rows


def _profile_frame(lt, rt, dev, frame_ms, frames=3):
    """Device time per frame by kernel (torch.profiler, CUPTI) and the
    device's busy share of the frame time measured without the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            _bench_run(lt, rt, dev)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()    # device activities only
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not events:
        print("[profile] the profiler saw no device time: busy share not measured")
        return
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / frames
    n_kernels = sum(e.count for e in events) / frames
    print(f"[profile] device busy {busy_ms:.4f} ms per frame of {frame_ms:.4f} ms "
          f"(idle share {1 - busy_ms / frame_ms:.4f}), {n_kernels:.1f} kernel "
          f"launches of {len(events)} kinds per frame")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile] {e.self_device_time_total / 1e3 / frames:9.4f} ms/frame "
              f"{e.count / frames:6.1f} calls/frame  {e.key[:90]}")


def _row(ms, plain_ms, nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import visionworkbench_torch  # noqa: F401  (fails when run without the repo)
    dev = "cuda"
    phase_build()
    smi = _smi()
    print(smi)
    err = phase_kernels(dev)
    counts = phase_main(dev)
    phase_slice_vs_cpu(dev)
    frame, rows = phase_timings(dev)
    heaviest = {"sweep": "level0_patches", "speckle": "1024x1024_11x11"}
    sources = {
        "sweep": ("visionworkbench_torch/csrc/sweep.cu",
                  "visionworkbench_tpu/ops/sweep.py:603"),
        "speckle": ("visionworkbench_torch/csrc/speckle.cu",
                    "visionworkbench_tpu/ops/speckle.py:93"),
    }
    kernels = []
    for k in ("sweep", "speckle"):
        r = rows[(k, heaviest[k])]
        kernels.append({
            "name": k, "route": "cuda", "source": sources[k][0],
            "replaces": sources[k][1], "launches": counts["plain"][k],
            "max_abs_err": err[k], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "shape": heaviest[k]})
    print(json.dumps({"frame_ms": frame["plain"]["ms"],
                      "frame_mps": frame["plain"]["mps"],
                      "frame_lr_ms": frame["consistency"]["ms"],
                      "card": smi}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
