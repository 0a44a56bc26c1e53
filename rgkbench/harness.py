"""The benchmark's frame: finds a cell's files by name, runs its window
driver, reads its per-layer metrics and prints the result line.

Everything that belongs to one configuration, traffic mix or metric is
a file of its own, found by the name in `BENCHMARK.json`:
* `configs/<config>.json`, the scene as run, and `configs/<config>.py`,
  `write(cfg, outdir)`, which writes its meshes and textures;
* `workloads/<cell>.json`, the cell's configuration, traffic and the
  name of its window driver;
* `drivers/<driver>.py`, one window loop per kind of traffic;
* `metrics/<metric>.py`, `read(rec)`, one reader per per-layer metric.
A configuration's files are written once per checkout into
`_scenes/<config>/`, beside a stamp of what wrote them.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import shutil
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
SCENES = os.path.join(BENCH, "_scenes")
CACHE = os.path.join(BENCH, "_cache")
# Top-level module names that no run may hold once its window closed:
# JAX and the JAX package the renderer was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "rgk_tpu")


def process_start() -> float:
    """The process's start on the `time.time()` clock, from /proc."""
    with open("/proc/self/stat") as f:
        ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


def cache_env() -> None:
    """Compile caches in fixed directories inside the checkout."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))


def read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def spec(root: str = ROOT) -> dict:
    return read_json(root, "BENCHMARK.json")


def load_module(kind: str, name: str):
    """`<kind>/<name>.py` of the benchmark as a module."""
    path = os.path.join(BENCH, kind, name + ".py")
    mod_name = f"rgkbench.{kind}.{name.replace('.', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    loader = importlib.util.spec_from_file_location(mod_name, path)
    if loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(loader)
    sys.modules[mod_name] = mod
    loader.loader.exec_module(mod)
    return mod


def workload(name: str) -> dict:
    return read_json(BENCH, "workloads", name + ".json")


def config(name: str) -> dict:
    return read_json(BENCH, "configs", name + ".json")


def _stamp(cfg: dict, name: str) -> str:
    h = hashlib.sha256(json.dumps(cfg, sort_keys=True).encode())
    for src in (os.path.join(BENCH, "configs", name + ".py"),
                os.path.join(BENCH, "meshes.py")):
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def scene_dir(name: str, root: str = SCENES, cfg=None) -> str:
    """The directory of configuration `name`'s files (`cfg` replaces its
    JSON), written on first use, or when its JSON or generator changed,
    through a temporary sibling that is renamed into place."""
    cfg = config(name) if cfg is None else cfg
    out = os.path.join(root, name)
    stamp = _stamp(cfg, name)
    stamp_path = os.path.join(out, "stamp")
    if os.path.exists(stamp_path):
        with open(stamp_path) as f:
            if f.read() == stamp:
                return out
    tmp = out + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    load_module("configs", name).write(cfg, tmp)
    with open(os.path.join(tmp, "stamp"), "w") as f:
        f.write(stamp)
    shutil.rmtree(out, ignore_errors=True)
    os.replace(tmp, out)
    return out


def scene_file(cell: str, wl: dict, root: str = SCENES, cfg=None) -> str:
    """The cell's scene JSON: its configuration's scene with the
    traffic's settings, beside the configuration's assets."""
    cfg = config(wl["config"]) if cfg is None else cfg
    d = scene_dir(wl["config"], root, cfg)
    scene = dict(cfg["scene"])
    for key in wl.get("drop", []):
        scene.pop(key, None)
    scene.update(wl.get("scene", {}))
    for key, value in wl.get("append", {}).items():
        scene[key] = list(scene.get(key, [])) + list(value)
    text = json.dumps(scene, indent=1)
    path = os.path.join(d, cell + ".json")
    if not os.path.exists(path) or open(path).read() != text:
        with open(path + ".tmp", "w") as f:
            f.write(text)
        os.replace(path + ".tmp", path)
    return path


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def quiet() -> None:
    """No progress lines from the renderer's or the reference's loaders
    on standard output."""
    from rgk_tpu_torch.utils import log

    from rgkbench.reference.utils import log as ref_log

    log.set_verbosity(0)
    ref_log.set_verbosity(0)


class Cell:
    """What a window driver gets: the cell's name, workload, seed and
    device, and its scene file."""

    def __init__(self, name, wl, seed, device, scenes=SCENES, cfg=None):
        self.name, self.wl, self.seed, self.device = name, wl, seed, device
        self.scene_path = scene_file(name, wl, scenes, cfg)


def per_layer(entries: list, cell: str, rec: dict) -> dict:
    """The per-layer metrics of `entries` that this cell reports, each
    read from `rec` by its reader; a reader that finds nothing to read
    returns None and its metric is left out."""
    got = {}
    for m in entries:
        if cell not in m.get("workloads", [cell]):
            continue
        value = load_module("metrics", m["name"]).read(rec)
        if value is not None:
            got[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return got


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             wl=None, started=None, root: str = ROOT, scenes=SCENES,
             entries=None, cfg=None) -> dict:
    """One run of cell `name`: set-up, the window, the traced reading
    with `trace`, the comparison; -> the result line as a dict.  `wl`
    and `cfg` replace the cell's workload and configuration files (the
    tests shrink them)."""
    import torch

    quiet()

    started = time.time() if started is None else started
    bench = spec(root) if entries is None else entries
    wl = workload(name) if wl is None else wl
    drv = load_module("drivers", wl["driver"])
    cell = Cell(name, wl, seed, device, scenes, cfg)
    state = drv.setup(cell)
    setup_s = time.time() - started
    out = drv.window(state, seconds, trace)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_reserved(device) if cuda else 0
    metrics = {}
    if trace:
        rec = drv.trace(state)
        rec.update(out.get("rec", {}))
        metrics = per_layer(bench["per_layer"], name, rec)
    else:
        for m in bench["end_to_end"]:
            if name not in m.get("workloads", [name]):
                continue
            value = setup_s if m["name"] == "setup_s" else out[m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = drv.judge(state)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda
                else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev_info}
    if trace:
        dev_info["busy_s"] = float(rec["busy_s"])
        dev_info["window_s"] = float(rec["traced_window_s"])
        result["breakdown"] = rec["breakdown"]
    result["checks"] = checks
    return result


def readings(name: str, seed: int, seconds: float, device, wl=None,
             scenes=SCENES, cfg=None, control: bool = True) -> dict:
    """Set-up and window of cell `name`, then its driver's readings:
    {"sound": numbers against the reference, and with `control`
    "control": numbers against the reference in the precision below,
    and faults' numbers where the driver reads them}."""
    quiet()
    wl = workload(name) if wl is None else wl
    drv = load_module("drivers", wl["driver"])
    state = drv.setup(Cell(name, wl, seed, device, scenes, cfg))
    drv.window(state, seconds, False)
    return drv.readings(state, control)


def main(argv=None, started=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    bench = spec()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0),
                      started=started)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
