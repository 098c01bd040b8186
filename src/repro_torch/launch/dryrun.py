"""Multi-pod dry run: one step of every (arch x shape) cell on the
production meshes, on fake tensors, and a record of its memory, FLOPs and
collectives: the JAX package's ``launch/dryrun.py``.

The JAX dry run lowers and compiles each cell's step for 256 or 512 CPU
devices and reads the compiled program.  The port compiles nothing: each
cell starts a fake world of the mesh's ranks in this process
(:func:`repro_torch.distributed.process_mesh.fake_world`), builds the
production mesh in it (:func:`repro_torch.launch.mesh.make_production_mesh`)
and, under ``FakeTensorMode`` (shapes and types, no data):

* builds the model's parameters and places them by the layout plan's
  rules (:func:`repro_torch.distributed.sharding.param_shardings`, as
  ``DTensor``: this rank's shard of each), with AdamW's moments in the
  parameters' layouts and its step count replicated (train), the batch
  (:func:`~repro_torch.distributed.sharding.batch_shardings`) and the
  decode caches (:func:`~repro_torch.distributed.sharding.cache_shardings`);
* runs the step of the shape's kind once (:mod:`.steps`; the plain
  routes, as the JAX dry run's CPU devices run the plain kernels) under
  :class:`repro_torch.launch.op_analysis.OpCounter`, which counts this
  rank's product FLOPs and collective bytes and the peak of the bytes the
  step makes;
* writes a record with the JAX record's keys: ``memory.argument_bytes``
  is the sum of this rank's shards of the step's arguments,
  ``temp_bytes`` the peak of what the step made and had not freed (its
  new outputs apart), ``alias_bytes`` the arguments the step updates in
  place (parameters and AdamW's state, or the caches), ``code_bytes`` 0;
  ``lower_s`` the fake step's seconds and ``compile_s`` null (nothing is
  compiled); ``cost_analysis`` the counted FLOPs and null bytes (no
  compiler reports them); ``hlo_dot_flops`` and ``hlo_collective_bytes``
  the counts, which are loop-aware by construction (``while_trips`` []).

:mod:`repro_torch.launch.roofline` reads the records unchanged, and
``tuning.static.compiled_plan_cost`` scores a layout plan by one.  A
skipped cell (``all_cells(include_skipped=True)``) gets the JAX skip
record.  Nothing here runs at import: the fake process group and
``FakeTensorMode`` are started inside :func:`dryrun_cell`.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape train_4k [--multi-pod] [--both-meshes] [--out build/artifacts]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --out build/artifacts
    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        --artifacts build/artifacts
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

from ..configs import all_cells, get_arch, get_shape
from ..distributed import sharding as sh
from ..distributed.process_mesh import fake_world, world_size
from ..models import build_model
from ..optim import adamw
from .mesh import PRODUCTION_SHAPES, make_production_mesh
from .op_analysis import analyze_step
from .steps import step_for_shape


def input_specs(model, shape) -> dict:
    """The step's inputs as (shape, dtype) leaves, the JAX model's
    ``input_specs``: train and prefill take tokens (and labels) of
    ``seq_len`` less a vision frontend's patches (B, F, d); an
    encoder-decoder's frames are (B, F or S / 2, d); decode takes the
    caches at ``seq_len``, one token a lane and its position."""
    cfg = model.cfg
    b, s = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    fe = cfg.frontend_seq if cfg.frontend != "none" else 0
    if shape.kind in ("train", "prefill"):
        if cfg.is_encoder_decoder:
            spec = {"tokens": ((b, s), i32)}
            frames = ((b, fe or s // 2, cfg.d_model), f32)
        else:
            spec = {"tokens": ((b, s - fe), i32)}
            frames = ((b, fe, cfg.d_model), f32) if fe else None
        if shape.kind == "train":
            spec["labels"] = spec["tokens"]
        if frames is not None:
            spec["frontend_embeds"] = frames
        return spec
    return {"token": ((b, 1), i32), "pos": ((b,), i32)}


def _empty(spec):
    if isinstance(spec, dict):
        return {k: _empty(v) for k, v in spec.items()}
    shape, dtype = spec
    return torch.zeros(shape, dtype=dtype)


def _nbytes(tree) -> int:
    """Bytes of this rank's shards of the tensor leaves of ``tree``."""
    total = 0
    for t in adamw.leaves(tree):
        if isinstance(t, torch.Tensor):
            local = getattr(t, "_local_tensor", t)
            total += local.numel() * local.element_size()
    return total


def dryrun_cell(arch_name: str, shape_name: str, *, multi_pod: bool = False,
                plan_name: str | None = None, remat: str = "full",
                num_microbatches: int | None = None,
                loss_chunks: int | None = None,
                verbose: bool = True) -> dict:
    """One step of the cell on fake tensors over the production mesh;
    returns the record.  Starts a fake world of the mesh's ranks unless
    a world is already up (a caller's own, of the mesh's size)."""
    cfg = get_arch(arch_name)
    shape = get_shape(shape_name)
    need = math.prod(PRODUCTION_SHAPES[multi_pod][0])
    world = (fake_world(need) if world_size() == 1
             else contextlib.nullcontext())
    with world:
        return _cell(cfg, shape, arch_name, shape_name, multi_pod,
                     plan_name, remat, num_microbatches, loss_chunks,
                     verbose)


def _cell(cfg, shape, arch_name, shape_name, multi_pod, plan_name, remat,
          num_microbatches, loss_chunks, verbose) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh.device_mesh                     # built outside the fake mode
    model = build_model(cfg)
    kind = shape.kind
    if num_microbatches is None:
        num_microbatches = 8 if kind == "train" else 1
    plan = sh.make_plan(cfg, kind, mesh, plan_name, remat=remat,
                        num_microbatches=num_microbatches)
    if loss_chunks is not None:
        plan.loss_chunks = loss_chunks
    fake = FakeTensorMode()
    t0 = time.time()
    with fake:
        full = model.init(0, "cpu", dtype=cfg.param_dtype)
        p_spec = sh.param_shardings(full, cfg, plan, mesh)
        plan.layer_specs = sh.layer_param_specs(full, cfg, plan, mesh)
        params = sh.place(full, p_spec, mesh)
        del full
        inputs = _empty(input_specs(model, shape))
        step = step_for_shape(model, shape, plan,
                              param_shardings=p_spec if kind == "train"
                              else None, use_kernel=False)
        if kind == "train":
            # the moments in the parameters' layouts, the step count
            # replicated (the JAX dry run's ``_opt_shardings``)
            opt = adamw.init(params)
            batch = sh.place(inputs, sh.batch_shardings(inputs, mesh), mesh)
            args, aliased = (params, opt, batch), (params, opt)
        elif kind == "prefill":
            batch = sh.place(inputs, sh.batch_shardings(inputs, mesh), mesh)
            args, aliased = (params, batch), ()
        else:
            full_caches = model.init_caches(shape.global_batch,
                                            shape.seq_len, "cpu")
            caches = sh.place(full_caches, sh.cache_shardings(
                full_caches, cfg, plan, mesh), mesh)
            del full_caches
            tok = sh.place(inputs, sh.batch_shardings(inputs, mesh), mesh)
            args = (params, caches, tok["token"], tok["pos"])
            aliased = (caches,)
        out, counts = analyze_step(step, *args, fake_mode=fake)
    t_lower = time.time() - t0
    arg_bytes = _nbytes(args)
    alias_bytes = _nbytes(aliased)
    new_out = [t for t in adamw.leaves(out) if isinstance(t, torch.Tensor)
               and not any(t is a for a in adamw.leaves(aliased))]
    out_bytes = alias_bytes + _nbytes(new_out)
    temp_bytes = max(counts["peak_bytes"] - _nbytes(new_out), 0)
    coll = counts["collective_bytes"]
    record = {
        "arch": arch_name, "shape": shape_name,
        "mesh": "x".join(str(mesh.shape[a]) for a in mesh.axis_names),
        "axes": list(mesh.axis_names), "chips": mesh.size,
        "plan": plan.name, "remat": plan.remat,
        "num_microbatches": plan.num_microbatches,
        "loss_chunks": plan.loss_chunks,
        "kind": kind,
        "lower_s": round(t_lower, 1), "compile_s": None,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp_bytes,
            "alias_bytes": alias_bytes,
            "code_bytes": 0,
        },
        "bytes_per_device": (arg_bytes + temp_bytes
                             + max(out_bytes - alias_bytes, 0)),
        "cost_analysis": {"flops": counts["dot_flops"],
                          "bytes_accessed": None},
        "collective_bytes": coll,
        "hlo_dot_flops": counts["dot_flops"],
        "hlo_collective_bytes": coll,
        "while_trips": counts["while_trips"],
        "model_params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    if verbose:
        print(f"[dryrun] {arch_name} x {shape_name} mesh={record['mesh']} "
              f"plan={plan.name} step={t_lower:.1f}s (fake tensors)")
        print(f"  memory: {record['memory']}")
        print(f"  dot flops a rank: {counts['dot_flops']:.3e}")
        print(f"  collective_bytes: { {k: f'{v:.3e}' for k, v in coll.items()} }")
    return record


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--plan", default=None)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--out", default="build/artifacts")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for a, s, ok, reason in all_cells(include_skipped=True):
            cells.append((a.name, s.name, ok, reason))
    else:
        cells.append((args.arch, args.shape, True, ""))

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    t_all = time.time()
    for arch, shape, ok, reason in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
            path = os.path.join(args.out, tag + ".json")
            if not ok:
                rec = {"arch": arch, "shape": shape, "skipped": True,
                       "reason": reason,
                       "mesh": "2x16x16" if mp else "16x16"}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"[dryrun] SKIP {tag}: {reason}")
                continue
            if os.path.exists(path):
                print(f"[dryrun] cached {tag}")
                continue
            try:
                rec = dryrun_cell(arch, shape, multi_pod=mp,
                                  plan_name=args.plan, remat=args.remat,
                                  num_microbatches=args.microbatches)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
            except Exception as e:
                traceback.print_exc()
                failures.append((tag, str(e)))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err[:200]}")
        raise SystemExit(1)
    print(f"\ndry-run complete in {time.time() - t_all:.1f}s.")


if __name__ == "__main__":
    main()
