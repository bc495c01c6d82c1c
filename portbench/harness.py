"""One run of one cell: set-up, the measured window, the traced segment,
the check against the plain reference, and the readings the metric
readers take.

A cell names a configuration file (`configs/<name>.json`: the encoder's
sizes as run, the optimizer and loss recipe, the weight rules, the
classes of the port and of the reference) and a traffic file
(`traffic/<name>.json`: "kind" train or serve, image size, batch, views,
pool, check and trace sizes).  The program is driven through its own
entries: `training/step.py:make_train_step` after the memory guard of
`training/loop.py` for a training mix; the encoder's forward and
`models/decoder.py:decode_splatting` at the predicted target pose for a
serving mix (the two calls that `evaluation/evaluator.py:
evaluate_example` times as "encoder" and "decoder").  Nothing here
imports JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import random
import statistics
import sys
import time
import typing
from dataclasses import dataclass, field
from pathlib import Path

import torch
from torch.profiler import record_function

from portbench import traffic as traffic_gen
from portbench import weights
from portbench.reference import precision
from portbench.trace import SPAN_PREFIX as SPAN

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PORT = "spfsplatv2_tpu_torch"
REFERENCE = "portbench.reference"
FORBIDDEN = ("jax", "jaxlib", "flax", "spfsplatv2_tpu")
# A leaf whose reference gradient is below this share of the median
# leaf's moves under Adam by round-off alone: its change is not compared.
MOVING_LEAF = 1e-3
# The pose telemetry a training step returns (the predicted pose of the
# last context view against its ground truth).
POSE_METRICS = ("pose/context_rot_deg", "pose/context_transl_deg")
GAUSSIAN_FIELDS = ("means", "covariances", "harmonics", "opacities")


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict | None


@dataclass
class Readings:
    """What one run hands the metric readers (`metrics/<name>.py`)."""

    kind: str
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    items: int                 # steps or requests completed in the window
    samples: int               # training samples completed in the window
    latencies_s: list
    spans: dict                # harness span name -> seconds per item
    flops_per_item: float | None
    peak_window_bytes: int | None
    launches: dict             # kernel -> launches per item
    trace: object = None       # trace.Trace of the traced segment
    # (rows reached, entries walked, pairs blended) of each K1 launch of
    # the traced segment (`raster_work.py`), counted after the segment
    raster: list | None = None


@dataclass
class Outcome:
    readings: Readings
    attempted: int
    failed: int
    memory_peak_bytes: int | None
    numbers: dict              # number compared -> value
    extra: dict = field(default_factory=dict)


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named `workload` in `root`'s BENCHMARK.json, with its
    configuration, traffic and limits files found by name."""
    bench = root / "portbench"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    tr = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    per_layer = [m for m in spec["per_layer"] if workload in m["workloads"]]
    lim = bench / "limits" / f"{workload}.json"
    limits = json.loads(lim.read_text()) if lim.exists() else None
    return Cell(workload, w["config"], config, w["traffic"], tr, e2e,
                per_layer, limits)


def resolve(path: str):
    """"package.module:attr" -> the object."""
    mod, _, attr = path.partition(":")
    return getattr(importlib.import_module(mod), attr)


def build(cls, values: dict):
    """The dataclass `cls` from a JSON dict: nested dataclasses from
    nested dicts, tuples from lists; an unknown key raises."""
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(values) - names
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            continue
        v, t = values[f.name], hints[f.name]
        if dataclasses.is_dataclass(t) and isinstance(v, dict):
            v = build(t, v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    return cls(**kw)


def all_float32(d):
    """The configuration with every compute dtype float32 (the reference)."""
    if isinstance(d, dict):
        return {k: ("float32" if k == "compute_dtype" else all_float32(v))
                for k, v in d.items()}
    return d


def side(prefix: str, module: str):
    return importlib.import_module(f"{prefix}.{module}")


def load_metric(name: str, bench: Path = BENCH):
    """The reader `metrics/<name>.py`, found by the metric's name."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


# --------------------------------------------------------------- models


def plans(cell: Cell) -> tuple[list, list]:
    """The weight plans of the encoder and of LPIPS, from the reference's
    modules on the meta device."""
    ref = cell.config["reference"]
    cfg = build(resolve(ref["config"]), all_float32(cell.config["encoder"]))
    with torch.device("meta"):
        enc = resolve(ref["encoder"])(cfg)
        lp = resolve(ref["lpips"])()
    return (weights.make_plan(enc, cell.config["init_rules"]),
            weights.make_plan(lp, cell.config["lpips_init_rules"]))


def make_encoder(cell: Cell, which: str, plan, seed: int, device):
    names = cell.config[which]
    enc_cfg = cell.config["encoder"]
    if which == "reference":
        enc_cfg = all_float32(enc_cfg)
    with torch.device(device):
        enc = resolve(names["encoder"])(build(resolve(names["config"]),
                                              enc_cfg))
    weights.load(enc, plan, traffic_gen.substream(seed, "weights"))
    return enc


def make_lpips(cell: Cell, which: str, plan, seed: int, device):
    with torch.device(device):
        lp = resolve(cell.config[which]["lpips"])()
    weights.load(lp, plan, traffic_gen.substream(seed, "lpips"))
    return lp.eval().requires_grad_(False)


def leaf_norms(tensors: dict) -> dict:
    names = list(tensors)
    norms = torch._foreach_norm([tensors[n].float() for n in names])
    return dict(zip(names, torch.stack(norms).cpu().tolist()))


def first_grads(encoder, optimizer) -> dict:
    """Each leaf's first gradient as the optimizer took it: its first
    moment after one update over (1 - b1); zero where it holds none (a
    skipped update)."""
    b1 = optimizer.adamw.defaults["betas"][0]
    out = {}
    for name, p in encoder.named_parameters():
        st = optimizer.adamw.state.get(p, {})
        out[name] = (st["exp_avg"] / (1.0 - b1) if "exp_avg" in st
                     else torch.zeros_like(p))
    return leaf_norms(out)


@torch.no_grad()
def changes(encoder, plan, seed: int) -> dict:
    """Each leaf's change from the seeded initial weights, made again."""
    params = dict(encoder.named_parameters())
    device = next(iter(params.values())).device
    out = {}
    for name, t0 in weights.generate(
            plan, traffic_gen.substream(seed, "weights"), device):
        out[name] = float(torch.linalg.vector_norm(params[name].float() - t0))
    return out


class FirstForward:
    """The encoder's first forward after this is made: its poses less the
    identity and its Gaussians at the sampled indices, on the host."""

    def __init__(self, encoder, idx: torch.Tensor):
        self.idx, self.out = idx, None
        self.handle = encoder.register_forward_hook(self)

    def __call__(self, module, args, output):
        if self.out is None:
            self.out = kept_batch(output["gaussians"], output["extrinsics_cwt"],
                                  self.idx)
            self.handle.remove()


class Capture:
    """One traced item's encoder forwards while this is registered: their
    Gaussians and the poses of the views from `v_cxt` on (the targets the
    item renders), detached, with the item's `target` views (batched)."""

    def __init__(self, encoder, v_cxt: int, target: dict):
        self.v_cxt, self.target, self.outs = v_cxt, target, []
        self.handle = encoder.register_forward_hook(self)

    def __call__(self, module, args, output):
        g = output["gaussians"]
        self.outs.append(({k: getattr(g, k).detach()
                           for k in GAUSSIAN_FIELDS},
                          output["extrinsics_cwt"][:, self.v_cxt:].detach()))


def capturing(encoder, v_cxt: int, run_item, target_of):
    """`run_item` with each item's encoder forwards captured (`Capture`,
    the item's targets from `target_of(k)`); -> (the wrapped item, the
    list its captures go to, in order)."""
    captures = []

    def item(k):
        captures.append(Capture(encoder, v_cxt, target_of(k)))
        try:
            return run_item(k)
        finally:
            captures[-1].handle.remove()

    return item, captures


def count_raster(cell: Cell, captures: list, log) -> list:
    """The walk of each K1 launch that rendered the captured items, item
    by item (a step's microbatches together, at its targets' intrinsics
    and near planes), by the reference's binning and walk: (rows,
    entries, pairs) a launch."""
    from portbench import raster_work

    tr = cell.traffic
    dec_cfg = build(side(REFERENCE, "models.decoder").DecoderConfig,
                    tr["decoder"])
    hw = tr["image_size"]
    work = []
    for cap in captures:
        gaussians = {k: torch.cat([o[0][k] for o in cap.outs])
                     for k in GAUSSIAN_FIELDS}
        extrinsics = torch.cat([o[1] for o in cap.outs])
        intrinsics, near = (cap.target[k].to(extrinsics.device)
                            for k in ("intrinsics", "near"))
        work += raster_work.render_work(gaussians, extrinsics, intrinsics,
                                        near, (hw, hw), dec_cfg)
    log(f"raster walk of the traced items: "
        f"{captures[0].outs[0][0]['means'].shape[1]} Gaussians a scene; "
        f"(rows reached, entries walked, pairs blended) a launch: "
        f"{json.dumps(work)}")
    return work


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative L2 gap of `a` to `b`; infinite where the shapes differ."""
    if a.shape != b.shape:
        return math.inf
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp(min=1e-30))


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's gap of norms, against the larger of the leaf's reference
    norm and the median leaf's."""
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in ref if keep is None or k in keep}


def moving_leaves(ref: dict) -> set:
    med = statistics.median(ref["grad"].values())
    return {k for k, v in ref["grad"].items() if v >= MOVING_LEAF * med}


def train_numbers(prog: dict, ref: dict) -> dict:
    """Each step's loss (the largest relative gap of the three), and the
    median leaf's gap of the first gradient and of the change after the
    checked steps (the worst leaf's are noise: `train_diagnostics`)."""
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(prog["loss"], ref["loss"]))
    return {"loss_gap": loss,
            **forward_numbers(prog["first"], ref["first"]),
            "grad_gap": statistics.median(
                leaf_gaps(prog["grad"], ref["grad"]).values()),
            "change_gap": statistics.median(leaf_gaps(
                prog["change"], ref["change"], moving_leaves(ref)).values())}


def train_diagnostics(prog: dict, ref: dict) -> dict:
    """Beside the numbers compared: the worst leaves' gaps and names, each
    step's loss gap and the pose telemetry's gap."""
    def worst(key, keep=None):
        gaps = leaf_gaps(prog[key], ref[key], keep)
        names = sorted(gaps, key=gaps.get, reverse=True)[:3]
        return [[k, gaps[k]] for k in names]

    moving = moving_leaves(ref)
    pose = max(abs(p - r) / max(abs(r), 1e-30)
               for ps, rs in zip(prog["pose"], ref["pose"])
               for p, r in zip(ps, rs))
    return {"worst_grad": worst("grad"), "worst_change": worst("change", moving),
            "step_loss_gaps": [abs(p - r) / max(abs(r), 1e-30)
                               for p, r in zip(prog["loss"], ref["loss"])],
            "pose_telemetry_gap": pose,
            "unmoved_leaves": len(ref["grad"]) - len(moving)}


def forward_numbers(p: dict, r: dict) -> dict:
    """The Gaussians (the largest field's relative L2) and the poses less
    the identity (relative L2) of one forward."""
    return {"gaussian_gap": max(rel(p["gaussians"][k], r["gaussians"][k])
                                for k in r["gaussians"]),
            "pose_gap": rel(p["poses"], r["poses"])}


def pose_angles(p: torch.Tensor, r: torch.Tensor) -> dict:
    """The worst view's rotation gap (`pose_rot_gap`) and gap of
    translation direction (`pose_dir_gap`), in degrees, between two sets
    of poses less the identity (`kept_batch`): neither scales with the
    unit baseline.  Directions only of views whose reference translation
    is over 1e-3 of the longest (view 0 is the origin)."""
    eye = torch.eye(4, dtype=torch.float64)
    p, r = p.double() + eye, r.double() + eye
    m = p[..., :3, :3].transpose(-1, -2) @ r[..., :3, :3]
    trace = m.diagonal(dim1=-2, dim2=-1).sum(-1)
    skew = torch.stack([m[..., 2, 1] - m[..., 1, 2],
                        m[..., 0, 2] - m[..., 2, 0],
                        m[..., 1, 0] - m[..., 0, 1]], dim=-1)
    rot = torch.atan2(torch.linalg.vector_norm(skew, dim=-1) / 2,
                      (trace - 1) / 2)
    tp, tq = p[..., :3, 3], r[..., :3, 3]
    norm = torch.linalg.vector_norm(tq, dim=-1)
    keep = norm > 1e-3 * norm.max()
    cross = torch.linalg.vector_norm(torch.linalg.cross(tp, tq), dim=-1)
    direction = torch.atan2(cross, (tp * tq).sum(-1))[keep]
    return {"pose_rot_gap": math.degrees(float(rot.abs().max())),
            "pose_dir_gap": math.degrees(float(direction.max()))
            if direction.numel() else 0.0}


def serve_numbers(prog: dict, ref: dict) -> dict:
    """The worst sampled request's render (its tile means), Gaussians (the
    largest field's gap, and each field's own: `<field>_gap`) and poses
    (the relative gap less the identity, and `pose_angles`)."""
    out = dict.fromkeys(("image_tile_gap", "gaussian_gap", "pose_gap",
                         "pose_rot_gap", "pose_dir_gap")
                        + tuple(f"{k}_gap" for k in GAUSSIAN_FIELDS), 0.0)
    for i, r in ref.items():
        p = prog.get(i)
        if p is None:   # a sampled request that never came
            return dict.fromkeys(out, math.inf)
        gaps = {"image_tile_gap": rel(tile_means(p["image"]),
                                      tile_means(r["image"])),
                **forward_numbers(p, r),
                **pose_angles(p["poses"], r["poses"]),
                **{f"{k}_gap": rel(p["gaussians"][k], r["gaussians"][k])
                   for k in GAUSSIAN_FIELDS}}
        out = {k: max(v, gaps[k]) for k, v in out.items()}
    return out


def serve_diagnostics(prog: dict, ref: dict) -> dict:
    """Beside the numbers compared: the full-resolution image's gap, not
    compared (PERF.md: bfloat16 alone moves Gaussians by about a pixel
    on screen, which decorrelates single pixels)."""
    return {"pixel_gap": max((rel(prog[i]["image"], r["image"])
                              for i, r in ref.items() if i in prog),
                             default=math.inf)}


def tile_means(image: torch.Tensor, tile: int = 16) -> torch.Tensor:
    """(..., h, w, 3) -> each 16 x 16 tile's mean colour."""
    x = image.reshape(-1, *image.shape[-3:]).permute(0, 3, 1, 2)
    return torch.nn.functional.avg_pool2d(x, tile)


# --------------------------------------------------------------- training


def reference_train(cell: Cell, seed: int, device, microbatch: int,
                    control: bool = False) -> dict:
    """The reference's first `check_steps` updates on the pool's first
    batches, from the same seeded weights, in microbatches of the
    program's size (the reprojection loss is normalised over each
    microbatch's valid pixels, so the size is part of the step's
    arithmetic): each step's loss, the first gradients and the changes
    after the last.  `control`: the bf16 parts in float8, the float32
    parts in TF32."""
    ref = REFERENCE
    tr, cfg = cell.traffic, cell.config
    enc_plan, lp_plan = plans(cell)
    enc = make_encoder(cell, "reference", enc_plan, seed, device)
    if control:
        precision.set_fp8(enc, cfg["bf16_parts"])
    lp = make_lpips(cell, "reference", lp_plan, seed, device)
    optim, step_mod = side(ref, "training.optim"), side(ref, "training.step")
    optimizer = optim.Optimizer(build(optim.OptimizerConfig, cfg["optimizer"]),
                                enc.named_parameters())
    loss_cfg = build(step_mod.LossConfig, cfg["loss"])
    dec_cfg = build(side(ref, "models.decoder").DecoderConfig, tr["decoder"])
    hw = tr["image_size"]
    out = {"loss": [], "pose": []}
    first = FirstForward(enc, gaussian_index(
        cell, traffic_gen.substream(seed, "gaussians"), device))
    with precision.tf32(control):
        for i in range(tr["check_steps"]):
            b = traffic_gen.batch(tr, seed, i, device)
            m = step_mod.train_step(enc, optimizer, b, i, (hw, hw), dec_cfg,
                                    loss_cfg, lp, microbatch)
            out["loss"].append(m["loss/total"])
            out["pose"].append([m[k] for k in POSE_METRICS])
            del b
            if i == 0:
                out["grad"] = first_grads(enc, optimizer)
    out["change"] = changes(enc, enc_plan, seed)
    out["first"] = first.out
    del enc, lp, optimizer, first
    free(device)
    return out


def run_train(cell: Cell, seed: int, seconds: float, trace: bool, device,
              t_start: float, log) -> Outcome:
    loop = side(PORT, "training.loop")
    optim = side(PORT, "training.optim")
    step_mod = side(PORT, "training.step")
    tr, cfg = cell.traffic, cell.config
    hw, b = tr["image_size"], tr["batch"]
    enc_plan, lp_plan = plans(cell)
    enc = make_encoder(cell, "port", enc_plan, seed, device)
    lp = make_lpips(cell, "port", lp_plan, seed, device)
    optimizer = optim.Optimizer(build(optim.OptimizerConfig, cfg["optimizer"]),
                                enc.named_parameters())
    state = step_mod.init_train_state(enc, optimizer)
    loss_cfg = build(step_mod.LossConfig, cfg["loss"])
    dec_cfg = build(side(PORT, "models.decoder").DecoderConfig, tr["decoder"])
    batches = traffic_gen.pool(tr, seed, device)
    # The memory guard, as `run_training` runs it before the first step.
    loss_kwargs = dict(image_shape=(hw, hw), decoder_cfg=dec_cfg,
                       loss_cfg=loss_cfg, lpips=lp, training_context=False,
                       distiller=None)
    microbatch, guard_gb = loop.fit_microbatch(
        lambda m: loop.probe_peak_gb(state, batches[0], m, loss_kwargs), b,
        None, loop.device_memory_gb(device))
    log(f"guard: microbatch {microbatch or b}, probe peak {guard_gb} GiB")
    step = step_mod.make_train_step(enc, optimizer, (hw, hw), dec_cfg,
                                    loss_cfg, lp, microbatch=microbatch)
    # The checked steps: the window's own call on the pool's first rows.
    first = FirstForward(enc, gaussian_index(
        cell, traffic_gen.substream(seed, "gaussians"), device))
    prog = {"loss": [], "pose": []}
    for i in range(tr["check_steps"]):
        state, m = step(state, batches[i])
        prog["loss"].append(m["loss/total"])
        prog["pose"].append([m[k] for k in POSE_METRICS])
        if i == 0:
            prog["grad"] = first_grads(enc, optimizer)
    prog["change"] = changes(enc, enc_plan, seed)
    prog["first"] = first.out
    del first
    sync(device)
    setup_s = time.perf_counter() - t_start
    cuda_lib = side(PORT, "ops.cuda_lib")
    peak = None
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    cuda_lib.reset_launch_counts()
    i, done, failed = tr["check_steps"], 0, 0
    skipped = optimizer.skipped_count
    step_s = []
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        try:
            state, m = step(state, batches[i % len(batches)])
            bad = (not math.isfinite(m["loss/total"])
                   or optimizer.skipped_count != skipped)
        except RuntimeError as err:
            log(f"step {i} raised: {err}")
            bad = True
        skipped = optimizer.skipped_count
        t = time.perf_counter()
        step_s.append(t - ts)
        i += 1
        failed += bad
        done += not bad
        if t - t0 >= seconds:
            break
    window_s = t - t0
    launches = {k: v / max(done + failed, 1)
                for k, v in cuda_lib.launch_counts.items() if v}
    window_peak = None
    if device.type == "cuda":
        window_peak = torch.cuda.max_memory_allocated(device)
        peak = max(peak, window_peak)
    spans = {"step": step_s}
    tr_read, captures = None, None
    if trace:
        item, captures = capturing(
            enc, len(tr["context_offsets"]),
            lambda k: step(state, batches[(i + k) % len(batches)]),
            lambda k: batches[(i + k) % len(batches)]["target"])
        tr_read, launches = traced(device, tr["trace_items"], item, "step")
    readings = Readings("train", cfg, tr, setup_s, window_s, done,
                        done * b, [], spans, flops(cell), window_peak,
                        launches, tr_read)
    del step, state, enc, lp, optimizer, batches, m
    free(device)
    if trace:
        readings.raster = count_raster(cell, captures, log)
        del captures
        free(device)
    ref = reference_train(cell, seed, device, microbatch or b)
    return Outcome(readings, done + failed, failed, peak,
                   train_numbers(prog, ref), {"microbatch": microbatch or b,
                                              **train_diagnostics(prog, ref)})


# --------------------------------------------------------------- serving


def serve_one(enc, decode, dec_cfg, req: dict, hw: int, device,
              spans: dict | None = None):
    """One request: its views to the device, the encoder, the render of
    the target at the predicted pose; returns (gaussians, poses, image)
    once the device has finished them."""
    ctx = {k: req["context"][k].to(device)[None]
           for k in ("image", "intrinsics")}
    tgt = {k: req["target"][k].to(device)[None]
           for k in ("image", "intrinsics", "near", "far")}
    v = ctx["image"].shape[1]
    t0 = time.perf_counter()
    if spans is not None:
        sync(device)
        t0 = time.perf_counter()
    with record_function(SPAN + "encoder"):
        out = enc(ctx["image"], ctx["intrinsics"], tgt["image"],
                  tgt["intrinsics"])
    if spans is not None:
        sync(device)
        t1 = time.perf_counter()
        spans["encoder"].append(t1 - t0)
        t0 = t1
    poses = out["extrinsics_cwt"]
    with record_function(SPAN + "decoder"):
        rendered = decode(out["gaussians"], poses[:, v:], tgt["intrinsics"],
                          tgt["near"], tgt["far"], (hw, hw), dec_cfg)
    sync(device)
    if spans is not None:
        spans["decoder"].append(time.perf_counter() - t0)
    return out["gaussians"], poses, rendered.color


def kept_batch(gaussians, poses, idx) -> dict:
    """A forward's outputs on the host: each view's pose less the identity
    (its motion from view 0) and the Gaussians at the sampled indices,
    for every row of the batch."""
    eye = torch.eye(4, device=poses.device)
    return {"poses": (poses.detach().float() - eye).cpu(),
            "gaussians": {k: getattr(gaussians, k).detach()[:, idx]
                          .float().cpu() for k in GAUSSIAN_FIELDS}}


def kept(gaussians, poses, image, idx) -> dict:
    """A served request's outputs on the host: its render, poses and
    sampled Gaussians."""
    return {"image": image[0].float().cpu(),
            **kept_batch(gaussians, poses, idx)}


def serve_sample(cell: Cell, seed: int) -> tuple[list, int]:
    tr = cell.traffic
    rng = random.Random(traffic_gen.substream(seed, "sample"))
    sample = sorted(rng.sample(range(tr["check_within"]),
                               tr["check_requests"]))
    return sample, traffic_gen.substream(seed, "gaussians")


def gaussian_index(cell: Cell, seed_g: int, device) -> torch.Tensor:
    tr = cell.traffic
    g = len(tr["context_offsets"]) * tr["image_size"] ** 2
    gen = torch.Generator().manual_seed(seed_g)
    return torch.randperm(g, generator=gen)[:tr["gaussian_sample"]].to(device)


@torch.no_grad()
def reference_serve(cell: Cell, seed: int, device, sample,
                    control: bool = False) -> dict:
    tr = cell.traffic
    enc_plan, _ = plans(cell)
    enc = make_encoder(cell, "reference", enc_plan, seed, device).eval()
    if control:
        precision.set_fp8(enc, cell.config["bf16_parts"])
    dec = side(REFERENCE, "models.decoder")
    dec_cfg = build(dec.DecoderConfig, tr["decoder"])
    idx = gaussian_index(cell, serve_sample(cell, seed)[1], device)
    out = {}
    with precision.tf32(control):
        for i in sample:
            req = traffic_gen.request(tr, seed, i % tr["pool"], device)
            out[i] = kept(*serve_one(enc, dec.decode_splatting, dec_cfg, req,
                                     tr["image_size"], device), idx)
    del enc
    free(device)
    return out


@torch.no_grad()
def run_serve(cell: Cell, seed: int, seconds: float, trace: bool, device,
              t_start: float, log) -> Outcome:
    tr, cfg = cell.traffic, cell.config
    hw = tr["image_size"]
    side(PORT, "evaluation.evaluator").disable_tf32()
    dec = side(PORT, "models.decoder")
    dec_cfg = build(dec.DecoderConfig, tr["decoder"])
    enc_plan, _ = plans(cell)
    enc = make_encoder(cell, "port", enc_plan, seed, device).eval()
    requests = traffic_gen.pool(tr, seed, device)
    sample, seed_g = serve_sample(cell, seed)
    idx = gaussian_index(cell, seed_g, device)

    def serve(i, spans=None):
        return serve_one(enc, lambda *a: dec.decode_splatting(*a), dec_cfg,
                         requests[i % len(requests)], hw, device, spans)

    for i in range(tr["warmup"]):
        serve(i)
    setup_s = time.perf_counter() - t_start
    cuda_lib = side(PORT, "ops.cuda_lib")
    peak = None
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    cuda_lib.reset_launch_counts()
    spans = {"encoder": [], "decoder": []} if trace else None
    prog, lat, done, failed, i = {}, [], 0, 0, 0
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        try:
            g, poses, image = serve(i, spans)
            t = time.perf_counter()
            lat.append(t - ts)
            bad = not bool(torch.isfinite(image).all()
                           and torch.isfinite(poses).all())
            if i in sample:
                prog[i] = kept(g, poses, image, idx)
            del g, poses, image
        except RuntimeError as err:
            log(f"request {i} raised: {err}")
            t, bad = time.perf_counter(), True
        i += 1
        failed += bad
        done += not bad
        if t - t0 >= seconds and i >= tr["check_within"]:
            break
    window_s = time.perf_counter() - t0
    launches = {k: v / max(i, 1) for k, v in cuda_lib.launch_counts.items()
                if v}
    window_peak = None
    if device.type == "cuda":
        window_peak = torch.cuda.max_memory_allocated(device)
        peak = max(peak, window_peak)
    tr_read, captures = None, None
    if trace:
        def target(k):
            t = requests[(i + k) % len(requests)]["target"]
            return {n: t[n][None] for n in ("intrinsics", "near")}

        item, captures = capturing(
            enc, len(tr["context_offsets"]),
            lambda k: serve(i + k, {"encoder": [], "decoder": []}), target)
        tr_read, launches = traced(device, tr["trace_items"], item, "request")
    readings = Readings("serve", cfg, tr, setup_s, window_s, done, done, lat,
                        spans or {}, flops(cell), window_peak, launches,
                        tr_read)
    del enc, requests
    free(device)
    if trace:
        readings.raster = count_raster(cell, captures, log)
        del captures
        free(device)
    ref = reference_serve(cell, seed, device, sample)
    return Outcome(readings, i, failed, peak, serve_numbers(prog, ref),
                   serve_diagnostics(prog, ref))


# --------------------------------------------------------------- tracing


def traced(device, items: int, run_item, span: str):
    """`items` more steps or requests under torch.profiler, each inside a
    harness span; -> (trace.Trace, kernel launches per item)."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace as trace_mod

    cuda_lib = side(PORT, "ops.cuda_lib")
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    cuda_lib.reset_launch_counts()
    with profile(activities=activities) as prof:
        sync(device)
        t0 = time.perf_counter()
        with record_function(SPAN + "segment"):
            for k in range(items):
                with record_function(SPAN + span):
                    run_item(k)
        sync(device)
        window_s = time.perf_counter() - t0
    launches = {k: v / items for k, v in cuda_lib.launch_counts.items()}
    return trace_mod.read(prof, window_s, items), launches


def flops(cell: Cell) -> float | None:
    """Model FLOPs a step or request, stored with the configuration under
    the traffic's name (`flops.py` counts them)."""
    return cell.config.get("model_flops", {}).get(cell.traffic_name)


RUNNERS = {"train": run_train, "serve": run_serve}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=lambda s: print(s, file=sys.stderr,
                                                 flush=True)) -> Outcome:
    torch.manual_seed(traffic_gen.substream(seed, "torch"))
    if device.type == "cuda":
        side(PORT, "ops.cuda_lib").build_all()
    return RUNNERS[cell.traffic["kind"]](cell, seed, seconds, trace, device,
                                         t_start, log)


def judge(cell: Cell, outcome: Outcome) -> tuple[bool, dict]:
    """Each number that the cell's limits file names, beside its limit;
    correct when every one is within it (a number without a limit is a
    diagnostic: PERF.md section 2 says why it has none)."""
    limits = (cell.limits or {}).get("limits", {})
    check = {k: {"value": outcome.numbers.get(k, math.inf), "limit": v}
             for k, v in limits.items()}
    correct = (bool(limits) and outcome.readings.items > 0
               and all(c["value"] <= c["limit"] for c in check.values()))
    return correct, check


def metrics_of(cell: Cell, readings: Readings, trace: bool,
               bench: Path = BENCH) -> dict:
    """The cell's end-to-end metrics (or, traced, its per-layer ones) that
    their readers find something to read for."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_metric(m["name"], bench)(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
