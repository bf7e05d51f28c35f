"""Process-group helpers of the port's multi-process tests (gloo on the
CPU).  Spawned children import this module by name, so it imports
neither JAX nor the reference package."""

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(fn, world: int, rendezvous, *args) -> None:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` spawned
    processes that join a gloo group through the file ``rendezvous`` (a
    fresh path); raises if any of them fails."""
    mp.start_processes(fn, args=(world, f"file://{rendezvous}") + args,
                       nprocs=world, start_method="spawn", join=True)


def _join(rank, world, init):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)


def ring_worker(rank, world, init, inputs, out):
    """Each array of ``inputs`` holds one contribution per rank along
    axis 0, for a ring of 2 or of 4.  A ring of 4 reduces over the
    default group, a ring of 2 over the pairs (0, 1) and (2, 3) as
    subgroups; each runs twice, the second time with the ring's rank 1
    sleeping before it joins.  Rank r writes ``{out}.{r}.npz``."""
    from repro_torch.optim import ordered_ring_reduce
    _join(rank, world, init)
    pairs = [dist.new_group(r) for r in ([0, 1], [2, 3])]
    pair = pairs[rank // 2]
    got = {}
    with np.load(inputs) as data:
        for name in data.files:
            x = data[name]
            group = None if x.shape[0] == world else pair
            me = dist.get_rank(group)
            for tag, delay in (("", 0.0), ("_delayed", 0.2)):
                if me == 1:
                    time.sleep(delay)
                got[name + tag] = ordered_ring_reduce(
                    torch.from_numpy(x[me]), group).numpy()
    np.savez(f"{out}.{rank}.npz", **got)
    dist.destroy_process_group()


def dp_worker(rank, world, init, states, out, steps, lr):
    """For each optimizer of ``states`` (name -> the path of a pickled
    numpy initial state, the reference's): ``steps`` of
    ``make_pot_dp_step`` on stablelm-smoke, twice from that state; rank 0
    writes both runs' state leaves, counters and losses to
    ``{out}.{optimizer}.npz``."""
    import pickle

    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.train import make_pot_dp_step
    from repro_torch.tree import leaves
    _join(rank, world, init)
    cfg = get_smoke_config("stablelm-12b")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8)
    for optimizer, path in states.items():
        with open(path, "rb") as f:
            ref_state = pickle.load(f)
        step = make_pot_dp_step(cfg, optimizer=optimizer, n_microbatches=2,
                                lr=lr)
        arrays = {}
        for r in range(2):
            state = convert.train_state_from_numpy(ref_state, cfg,
                                                   device="cpu")
            losses = []
            for i in range(steps):
                state, loss = step(state, batch_at(dcfg, i, device="cpu"))
                losses.append(float(loss))
            arrays[f"losses_{r}"] = np.asarray(losses, np.float32)
            arrays[f"counters_{r}"] = np.asarray(
                [int(state.gv), int(state.step)])
            for j, t in enumerate(leaves([state.params, state.opt])):
                arrays[f"leaf_{r}_{j}"] = t.numpy()
        if rank == 0:
            np.savez(f"{out}.{optimizer}.npz", **arrays)
    dist.destroy_process_group()


def dp_kinds_worker(rank, world, init, cases, out, lr):
    """For each case of ``cases`` (the path of a pickled dict: (arch,
    optimizer) -> (the reference's initial state, the global batch), as
    numpy), one ``make_pot_dp_step`` step of 2 microbatches a rank on the
    smoke configuration, twice from that state, with ``C`` set to
    float32 in the port's model modules; rank r writes both runs' state
    leaves, counters and losses to ``{out}.{arch}.{optimizer}.{r}.npz``."""
    import pickle

    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import blocks, lm, moe, rglru, ssm
    from repro_torch.train import make_pot_dp_step
    from repro_torch.tree import leaves
    for m in (blocks, lm, ssm, rglru, moe):
        m.C = torch.float32
    _join(rank, world, init)
    with open(cases, "rb") as f:
        cases = pickle.load(f)
    for (arch, optimizer), (initial, batch) in cases.items():
        cfg = get_smoke_config(arch)
        step = make_pot_dp_step(cfg, optimizer=optimizer, n_microbatches=2,
                                lr=lr)
        arrays = {}
        for r in range(2):
            state = convert.train_state_from_numpy(initial, cfg, device="cpu")
            state, loss = step(state, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
            arrays[f"loss_{r}"] = loss.numpy()
            arrays[f"counters_{r}"] = np.asarray(
                [int(state.gv), int(state.step)])
            for j, t in enumerate(leaves([state.params, state.opt])):
                arrays[f"leaf_{r}_{j}"] = t.numpy()
        np.savez(f"{out}.{arch}.{optimizer}.{rank}.npz", **arrays)
    dist.destroy_process_group()


def placement_worker(rank, world, init, out):
    """Every leaf of stablelm-smoke's and deepseek-moe-smoke's parameters
    (seeded draws, the same on both ranks) distributed by its spec under
    a single-pod profile on (1, 2) and (2, 1) meshes and under a
    multi-pod ``pure_dp`` profile on (1, 2, 1) (tuple entries), each
    gathered back and checked bitwise, its local shard's shape checked
    against ``local_shape``; ``cons`` to a replicated spec gathers too.
    Rank r writes the file ``{out}.{r}`` when all hold."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.runtime.shardings import (P, Profile, cons,
                                               local_shape, to_placements)
    from repro_torch.tree import flatten_up_to, leaves
    _join(rank, world, init)
    meshes = [((1, 2), ("data", "model"), {}),
              ((2, 1), ("data", "model"), {}),
              ((1, 2, 1), ("pod", "data", "model"),
               {"data_axes": ("pod", "data"), "pure_dp": True})]
    for arch in ("stablelm-12b", "deepseek-moe-16b"):
        cfg = get_smoke_config(arch)
        params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                                dtype=torch.float32)
        for shape, names, kw in meshes:
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            prof = Profile(mesh=mesh, **kw)
            sizes = dict(zip(names, shape))
            specs = flatten_up_to(params, lm.param_specs(cfg, prof))
            for t, spec in zip(leaves(params), specs, strict=True):
                if kw.get("pure_dp") and spec.count("model") and any(
                        isinstance(e, tuple) for e in spec):
                    continue   # pure_dp experts: the model axis twice
                d = distribute_tensor(t, mesh,
                                      to_placements(spec, mesh, t.ndim))
                if rank == 0:
                    assert tuple(d.to_local().shape) == local_shape(
                        tuple(t.shape), spec, sizes), (spec, t.shape)
                assert torch.equal(d.full_tensor(), t), (arch, spec)
                back = cons(d, P(), prof)
                assert torch.equal(back.to_local(), t), (arch, spec)
    open(f"{out}.{rank}", "w").close()
    dist.destroy_process_group()


def mesh_worker(rank, world, init, out):
    """``make_host_mesh`` over the gloo world: one ``"data"`` axis of
    ``world`` ranks that an all-reduce over its group spans.  Rank r
    writes the file ``{out}.{r}`` when all hold."""
    from repro_torch.launch.mesh import make_host_mesh
    _join(rank, world, init)
    mesh = make_host_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data",) and mesh.size() == world
    assert mesh.get_local_rank("data") == rank
    x = torch.tensor([rank + 1.0])
    dist.all_reduce(x, group=mesh.get_group("data"))
    assert x.item() == world * (world + 1) / 2
    named = make_host_mesh(world, axis="shard", device_type="cpu")
    assert named.mesh_dim_names == ("shard",)
    open(f"{out}.{rank}", "w").close()
    dist.destroy_process_group()


def _mesh_profile(shape, **kw):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.runtime.shardings import Profile
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    return mesh, Profile(mesh=mesh, **kw)


def _f32_models():
    from repro_torch.models import blocks, lm, moe, rglru, ssm
    for m in (blocks, lm, ssm, rglru, moe):
        m.C = torch.float32


@contextlib.contextmanager
def _routing(rec: list):
    """Within the block, each routing of the port's MoE layer appends
    (expert index (T*k,), kept (T*k,)) to ``rec``."""
    from repro_torch.models import moe
    orig = moe.dispatch_positions

    def recording(flat_e, e, cap, *by_e):
        pos, keep = orig(flat_e, e, cap, *by_e)
        rec.append((flat_e.numpy().copy(), keep.numpy().copy()))
        return pos, keep
    moe.dispatch_positions = recording
    try:
        yield rec
    finally:
        moe.dispatch_positions = orig


def _moe_ep_layer(case, cfg, prof) -> dict:
    from repro_torch import convert
    from repro_torch.models import moe
    params = convert.lm_params_from_numpy(case["params"], cfg, "cpu",
                                          torch.float32, prof)
    p = {k: v.requires_grad_(True) if k in ("router",) + moe.EXPERT_LEAVES
         else v for k, v in params["layers"][0]["moe"].items()}
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    with _routing([]) as rec:
        y = moe.moe_apply(p, x, cfg, prof)
    names = ("x", "router") + moe.EXPERT_LEAVES
    grads = torch.autograd.grad(y, [x] + [p[n] for n in names[1:]],
                                torch.from_numpy(case["ct"]))
    return dict(y=y.detach().numpy(), routing=rec,
                grads={n: g.numpy() for n, g in zip(names, grads)})


def _moe_ep_model(case, cfg, prof) -> dict:
    from repro_torch import convert
    from repro_torch.models import lm
    from repro_torch.serve.session import Session
    params = convert.lm_params_from_numpy(case["params"], cfg, "cpu",
                                          torch.float32, prof)
    tokens = torch.from_numpy(case["tokens"])
    out = {}
    with torch.no_grad():
        with _routing([]) as rec:
            out["logits"] = lm.forward(params, tokens, cfg, prof).numpy()
        out["forward_routing"] = rec
        out["prefill"] = lm.prefill(params, tokens, cfg, prof)[0].numpy()
        cache = lm.local_cache(convert.lm_cache_from_numpy(
            case["cache"], cfg, "cpu", torch.float32), cfg, prof)
        with _routing([]) as rec:
            logits, cache = lm.decode_step(
                params, cache, torch.from_numpy(case["dec_tokens"]),
                torch.from_numpy(case["pos"]), cfg, prof)
        out["decode"] = logits.numpy()
        out["decode_routing"] = rec
        sess = Session(cfg, params, n_slots=tokens.shape[0], max_seq=32,
                       device="cpu", prof=prof)
        first = sess.prefill(tokens[:, :8])
        out["session"] = np.concatenate([first[:, None], sess.generate(4)],
                                        axis=1)
        out["fingerprint"] = sess.fingerprint()
    return out


def _moe_ep_train(case, cfg, prof, delayed: bool,
                  optimizer: str = "adamw") -> dict:
    from repro_torch import convert
    from repro_torch.train import make_train_step
    from repro_torch.tree import leaves
    state = convert.train_state_from_numpy(case["state"], cfg, "cpu", prof)
    step = make_train_step(cfg, prof=prof, optimizer=optimizer, mode="pot",
                           n_microbatches=2, lr=case["lr"])
    grad = torch.autograd.grad
    if delayed:     # this rank joins each backward 0.2 s late

        def late(*args, **kwargs):
            time.sleep(0.2)
            return grad(*args, **kwargs)
        torch.autograd.grad = late
    try:
        new, loss = step(state, {k: torch.from_numpy(v)
                                 for k, v in case["batch"].items()})
    finally:
        torch.autograd.grad = grad
    return dict(loss=loss.numpy(), counters=[int(new.gv), int(new.step)],
                leaves=[t.numpy() for t in leaves([new.params, new.opt])])


def _refusals(prof) -> dict:
    """The messages of what the schedule refuses on this mesh."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    from repro_torch.runtime.shardings import local_tree
    cfg = get_smoke_config("deepseek-moe-16b")
    gen = torch.Generator().manual_seed(0)
    p = local_tree(moe.init_moe(gen, cfg, torch.float32),
                   moe.moe_specs(cfg, prof), prof.mesh)
    x = lambda b, s, grad=False: torch.zeros(
        (b, s, cfg.d_model), requires_grad=grad)
    six = dataclasses.replace(cfg, n_experts=6)
    calls = {
        "experts": lambda: moe.moe_apply(moe.init_moe(gen, six, torch.float32),
                                         x(4, 8), six, prof),
        "batch": lambda: moe.moe_apply(p, x(3, 8), cfg, prof),
        "whole": lambda: moe.moe_apply(moe.init_moe(gen, cfg, torch.float32),
                                       x(4, 8), cfg, prof),
        "gradient": lambda: moe.moe_apply(p, x(4, 1, True), cfg, prof),
        "fsdp": lambda: moe.moe_apply(
            p, x(4, 8), cfg, dataclasses.replace(prof, fsdp=False)),
        "pure_dp": lambda: moe.moe_apply(
            p, x(8, 8), cfg, dataclasses.replace(prof, pure_dp=True)),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def moe_ep_worker(rank, world, init, inputs, out, parts):
    """The port's expert-parallel MoE on a (2, 4) ("data", "model") mesh
    of gloo ranks, in float32 (``C`` set in the port's model modules),
    for each case of the pickled ``inputs`` ((arch, capacity factor) ->
    the reference's numpy weights and the inputs): ``parts`` of "layer"
    (output, gradients, routing), "model" (``lm.forward`` and its
    routing, ``lm.prefill``, one ``decode_step`` and its routing, a
    ``Session`` prefill and 4 steps), "train" (one pot step, AdamW, 2
    microbatches, twice: the second time the rank at data 1, model 0
    joins each backward late) and "refusals".  Rank r writes
    ``{out}.{r}.pkl``."""
    import dataclasses
    import pickle

    from repro_torch.configs import get_smoke_config
    _join(rank, world, init)
    _f32_models()
    mesh, prof = _mesh_profile((2, world // 2))
    with open(inputs, "rb") as f:
        cases = pickle.load(f)
    result = {"coord": tuple(mesh.get_coordinate())}
    for (arch, cf), case in cases.items():
        cfg = get_smoke_config(arch)
        if cf is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=cf)
        got = {}
        if "layer" in parts:
            got["layer"] = _moe_ep_layer(case, cfg, prof)
        if "model" in parts:
            got["model"] = _moe_ep_model(case, cfg, prof)
        if "train" in parts:
            late = result["coord"] == (1, 0)
            got["train"] = [_moe_ep_train(case, cfg, prof, d and late)
                            for d in (False, True)]
        result[(arch, cf)] = got
    if "refusals" in parts:
        result["refusals"] = _refusals(prof)
    with open(f"{out}.{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


def moe_ep_world1_worker(rank, world, init, archs, out):
    """One gloo rank, a (1, 1) mesh: in bf16, for each arch of ``archs``
    at capacity factor 1.0, the MoE layer's output and gradients,
    ``lm.forward``, ``lm.prefill``, a ``decode_step``, a ``Session``
    (prefill and 4 steps) and one pot train step (AdamW, 2 microbatches)
    through the schedule, each bitwise equal to the dense path.  Writes
    the file ``{out}`` when all hold."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm, moe
    from repro_torch.runtime.shardings import SMOKE
    from repro_torch.serve.session import Session
    from repro_torch.train import init_state, make_train_step
    from repro_torch.tree import leaves
    _join(rank, world, init)
    _, prof = _mesh_profile((1, 1))
    bits = lambda t: t.view(torch.int16 if t.element_size() == 2 else
                            torch.int32) if t.is_floating_point() else t
    same = lambda a, b: len(a) == len(b) and all(
        torch.equal(bits(x), bits(y)) for x, y in zip(a, b))
    for arch in archs:
        cfg = dataclasses.replace(get_smoke_config(arch), capacity_factor=1.0)
        gen = lambda s: torch.Generator().manual_seed(s)
        master = lm.init_params(gen(0), cfg, dtype=torch.float32)
        params = lm.init_params(gen(0), cfg)
        x = torch.randn((4, 32, cfg.d_model), generator=gen(1)).to(lm.C)
        ct = torch.randn((4, 32, cfg.d_model), generator=gen(2)).to(lm.C)
        tokens = torch.randint(0, cfg.vocab, (4, 32), generator=gen(3))
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
        runs = []
        for pr in (SMOKE, prof):
            run = []
            p = {k: v.detach().clone().requires_grad_(True)
                 if torch.is_tensor(v) else v
                 for k, v in master["layers"][0]["moe"].items()}
            xg = x.clone().requires_grad_(True)
            y = moe.moe_apply(p, xg, cfg, pr)
            run += [y, *torch.autograd.grad(
                y, [xg] + [p[n] for n in ("router",) + moe.EXPERT_LEAVES],
                ct)]
            with torch.no_grad():
                run.append(lm.forward(params, tokens, cfg, pr))
                logits, cache = lm.prefill(params, tokens, cfg, pr,
                                           max_seq=40)
                pos = torch.full((4,), 32)
                run += [logits, *lm.decode_step(params, cache, tokens[:, :1],
                                                pos, cfg, pr)[:1]]
                sess = Session(cfg, params, n_slots=4, max_seq=32,
                               device="cpu", prof=pr)
                run += [torch.from_numpy(sess.prefill(tokens[:, :8])),
                        torch.from_numpy(sess.generate(4)),
                        torch.tensor(sess.fingerprint())]
            step = make_train_step(cfg, prof=pr, mode="pot",
                                   n_microbatches=2)
            new, loss = step(init_state(master), batch)
            run += [loss, *leaves([new.params, new.opt])]
            runs.append([t.detach() for t in run])
        assert same(*runs), f"{arch}: the schedule differs from the dense path"
    open(out, "w").close()
    dist.destroy_process_group()


def store_mesh_worker(rank, world, init, snap_dir, out, part):
    """One store shard per rank (``tests/_torch_store_mesh.py``): 1-D
    ``("shard",)`` meshes of 1, 2 and 8 ranks, each cut from a 2-D mesh
    of the world.  Records, as numpy, for ``part`` "reference": PCC on
    ``shard_store(dense, s, mesh=)`` for each (workload, mesh size) of
    ``RUNS``, a ``PotSession(shards=8, mesh=)`` over the counters batch
    and the wrong-sized meshes' refusals; for "engines": every engine
    over a stream of two counters batches on the meshes of
    ``ENGINE_SIZES`` at depth 0 and 2, beside the dense session's, and
    snapshots from 8 ranks into the dense store and from the dense store
    into 8 ranks, and a replica killed and resumed on 8 ranks against the
    dense one.  Rank r writes ``{out}.{r}.pkl``."""
    import pickle

    from torch.distributed.device_mesh import init_device_mesh

    import _torch_store_mesh as sm
    from repro_torch.core import workloads as W
    _join(rank, world, init)
    meshes = {s: init_device_mesh("cpu", (world // s, s),
                                  mesh_dim_names=("rep", "shard"))["shard"]
              for s in sm.SIZES}
    wls = sm.workloads(W, device="cpu")
    if part == "reference":
        result = _store_mesh_reference(wls, meshes)
    else:
        result = _store_mesh_engines(wls["counters"], meshes, snap_dir, rank)
    with open(f"{out}.{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


def _store_mesh_reference(wls, meshes) -> dict:
    import _torch_store_mesh as sm
    from repro_torch import convert
    from repro_torch.core.pcc import pcc_execute
    from repro_torch.core.sequencer import RoundRobinSequencer
    from repro_torch.core.session import PotSession
    from repro_torch.core.tstore import (ShardedStore, fingerprint,
                                         make_store, shard_store)
    result = {}
    for name, s in sm.RUNS:
        wl = wls[name]
        seq = torch.as_tensor(RoundRobinSequencer(n_root_lanes=wl.n_lanes)
                              .order_for(wl.lanes.tolist()),
                              dtype=torch.int32)
        sharded = shard_store(make_store(wl.n_objects, device="cpu"), s,
                              mesh=meshes[s])
        assert isinstance(sharded, ShardedStore)
        assert tuple(sharded.values.shape) == (1, -(-wl.n_objects // s), 1)
        store, trace = pcc_execute(sharded, wl.batch, seq)
        result[(name, s)] = dict(fingerprint=fingerprint(store),
                                 trace=convert.trace_to_numpy(trace))
    wl = wls["counters"]
    sess = PotSession(wl.n_objects, engine="pcc", n_lanes=wl.n_lanes,
                      shards=8, mesh=meshes[8], device="cpu")
    trace = sess.submit(wl.batch, wl.lanes.tolist())
    result["session"] = dict(fingerprint=sess.fingerprint(),
                             replay=sess.replay_log(),
                             trace=convert.trace_to_numpy(trace))
    refusals = {}
    for tag, call in (
            ("shard_store", lambda: shard_store(make_store(80, device="cpu"),
                                                4, mesh=meshes[8])),
            ("make_store", lambda: make_store(80, shards=2, mesh=meshes[8],
                                              device="cpu")),
            ("session", lambda: PotSession(80, shards=1, mesh=meshes[2],
                                           device="cpu")),
            ("not_a_mesh", lambda: make_store(80, shards=2, mesh=object(),
                                              device="cpu"))):
        try:
            call()
            refusals[tag] = None
        except ValueError as e:
            refusals[tag] = str(e)
    result["refusals"] = refusals
    return result


def _store_mesh_engines(wl, meshes, snap_dir, rank) -> dict:
    import os

    import _torch_store_mesh as sm
    from repro_torch import convert
    from repro_torch.core import workloads as W
    from repro_torch.core.checkpoint import (FaultInjected, FaultPlan,
                                             run_replica)
    from repro_torch.core.ingress import IngressPool, programs_from_batch
    from repro_torch.core.session import PotSession
    from repro_torch.core.tstore import unshard_store
    lanes = wl.lanes.tolist()
    second = W.counters(**dict(sm.COUNTERS, seed=7), device="cpu")
    stream = [wl.batch, second.batch]
    stream_lanes = [lanes, second.lanes.tolist()]

    def run(**kw):
        s = PotSession(wl.n_objects, n_lanes=wl.n_lanes, device="cpu", **kw)
        ts = s.run_stream(stream, stream_lanes)
        return dict(fingerprint=s.fingerprint(), replay=s.replay_log(),
                    traces=[convert.trace_to_numpy(t) for t in ts],
                    spec=sum(int(t.spec_executed) for t in ts))

    result = {}
    for engine in sm.ENGINES:
        for depth in (0, 2):
            result[("engine", engine, depth, 0)] = run(
                engine=engine, pipeline_depth=depth)
            for s in sm.ENGINE_SIZES[depth]:
                result[("engine", engine, depth, s)] = run(
                    engine=engine, pipeline_depth=depth, shards=s,
                    mesh=meshes[s])

    # snapshots: 8 ranks -> the dense store, the dense store -> 8 ranks
    snap8 = os.path.join(snap_dir, "mesh8")
    snap1 = os.path.join(snap_dir, f"dense.{rank}")
    s8 = PotSession(wl.n_objects, n_lanes=wl.n_lanes, shards=8,
                    mesh=meshes[8], device="cpu")
    s8.submit(wl.batch, lanes)
    s8.snapshot(snap8)
    dense, _ = PotSession.restore(snap8, shards=1, device="cpu")
    s1 = PotSession(wl.n_objects, n_lanes=wl.n_lanes, device="cpu")
    s1.submit(wl.batch, lanes)
    s1.snapshot(snap1)
    back, _ = PotSession.restore(snap1, shards=8, mesh=meshes[8],
                                 device="cpu")
    sessions = (dense, back, s1, s8)
    for s in sessions:
        s.submit(second.batch, second.lanes.tolist())
    result["snapshots"] = dict(
        dense_layout=(type(dense.store).__name__, dense.store.layout.shards),
        back_layout=(type(back.store).__name__, back.store.layout.shards,
                     tuple(back.store.values.shape)),
        fingerprints=[s.fingerprint() for s in sessions],
        replays=[s.replay_log() for s in sessions],
        images=[convert.store_to_numpy(unshard_store(s.store))
                for s in sessions])

    # a replica on 8 ranks killed after batch 3 and resumed from its
    # last snapshot, against the dense replica served through
    pool = IngressPool(capacity=512)
    for i, p in enumerate(programs_from_batch(wl.batch)):
        pool.admit(p, lane=i % wl.n_lanes, fee=i % 5)
    journal = pool.arrival_journal()
    kw = dict(n_objects=wl.n_objects, n_lanes=wl.n_lanes, budgets=(7, 11),
              device="cpu")
    base = run_replica(journal, directory=os.path.join(
        snap_dir, f"replica.{rank}"), snapshot_every=0, **kw)
    victim = os.path.join(snap_dir, "replica_mesh8")
    mesh_kw = dict(kw, shards=8, mesh=meshes[8], snapshot_every=2)
    try:
        run_replica(journal, directory=victim, fault_plan=FaultPlan(
            kill_batch=3, action="raise"), **mesh_kw)
    except FaultInjected:
        pass
    rec = run_replica(journal, directory=victim, resume=True, **mesh_kw)
    result["replica"] = dict(
        restored_from=rec.session.restored_from,
        layout=rec.session.store.layout.shards,
        fingerprints=(base.session.fingerprint(), rec.session.fingerprint()),
        replays=(base.session.replay_log(), rec.session.replay_log()))
    return result


def _tp_layer(case, cfg, prof) -> dict:
    from repro_torch import convert
    from repro_torch.models import lm
    from repro_torch.runtime.shardings import Place
    from repro_torch.tree import leaves
    layer = convert.lm_params_from_numpy(case["params"], cfg, "cpu",
                                         torch.float32, prof)["layers"][0]
    leaf = [t.requires_grad_(True) for t in leaves(layer)]
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    place = Place(prof, x.shape)
    b, s, _ = x.shape
    pos = torch.arange(s)[None].expand(b, s)
    y, _ = lm._sublayer(layer, place.whole_out(x), kind=cfg.pattern[0],
                        cfg=cfg, prof=prof, place=place,
                        positions=place.batch_block(pos), enc=None,
                        causal=True, chunk=0, collect=False, max_seq=0)
    y = place.whole_in(y)
    grads = torch.autograd.grad(y, [x] + leaf, torch.from_numpy(case["ct"]))
    return dict(y=y.detach().numpy(), gx=grads[0].numpy(),
                gp=[g.numpy() for g in grads[1:]])


def _forward_flops(params, tokens, extra, cfg, prof) -> int:
    """The FLOPs (``FlopCounterMode``) of ``lm.forward`` on ``prof``,
    whisper's ``lm.encode`` included."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import lm
    with FlopCounterMode(display=False) as counter:
        lm.forward(params, tokens, cfg, prof, **_model_kw(
            params, extra, cfg, prof))
    return counter.get_total_flops()


def _model_kw(params, extra, cfg, prof) -> dict:
    """``lm.forward``'s and ``lm.prefill``'s keywords for an arch's
    extra inputs: whisper's encoder output (the rank's rows on a mesh),
    internvl2's patch prefix."""
    from repro_torch.models import lm
    kw = {}
    if "frames" in extra:
        kw["enc"] = lm.encode(params, extra["frames"], cfg, prof)
    if "patches" in extra:
        kw["prefix_embeds"] = extra["patches"]
    return kw


def _tp_model(case, cfg, prof, session: bool) -> dict:
    import _torch_tp as tp
    from repro_torch import convert
    from repro_torch.models import lm
    from repro_torch.runtime.shardings import SMOKE
    from repro_torch.serve.session import Session
    params = convert.lm_params_from_numpy(case["params"], cfg, "cpu",
                                          torch.float32, prof)
    tokens = torch.from_numpy(case["tokens"])
    extra = {k: torch.from_numpy(v) for k, v in case["extra"].items()}
    out = {}
    with torch.no_grad():
        kw = _model_kw(params, extra, cfg, prof)
        out["logits"] = lm.forward(params, tokens, cfg, prof, **kw).numpy()
        whole = convert.lm_params_from_numpy(case["params"], cfg, "cpu",
                                             torch.float32)
        out["flops"] = (_forward_flops(params, tokens, extra, cfg, prof),
                        _forward_flops(whole, tokens, extra, cfg, SMOKE))
        last, cache = lm.prefill(params, tokens, cfg, prof,
                                 max_seq=tp.MAX_SEQ, **kw)
        out["prefill"] = last.numpy()
        out["cache"] = [{n: t.numpy() for n, t in c.items()} for c in cache]
        cache = lm.local_cache(convert.lm_cache_from_numpy(
            case["cache"], cfg, "cpu", torch.float32), cfg, prof)
        logits, cache = lm.decode_step(
            params, cache, torch.from_numpy(case["dec_tokens"]),
            torch.from_numpy(case["pos"]), cfg, prof)
        out["decode"] = logits.numpy()
        if session:
            sess = Session(cfg, params, n_slots=tokens.shape[0], max_seq=32,
                           device="cpu", prof=prof)
            first = sess.prefill(tokens[:, :8])
            out["session"] = np.concatenate(
                [first[:, None], sess.generate(4)], axis=1)
            out["fingerprint"] = sess.fingerprint()
    return out


def _tp_tied(case, cfg, prof) -> dict:
    """Tied embeddings (the head ``embed`` transposed; no config ties
    them) from the reference's tied weights and states: ``lm.forward``'s
    logits over the case's batch and a pot step of each optimizer (2
    microbatches), "mesh" on the rank's shards and "dense" whole on the
    rank."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.models import lm
    from repro_torch.runtime.shardings import SMOKE
    tied = case["tied"]
    cfg = dataclasses.replace(cfg, tie_embeddings=True)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    extra = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    out = {}
    for path, pr in (("mesh", prof), ("dense", SMOKE)):
        params = convert.lm_params_from_numpy(tied["params"], cfg, "cpu",
                                              torch.float32, pr)
        with torch.no_grad():
            logits = lm.forward(params, batch["tokens"], cfg, pr,
                                **_model_kw(params, extra, cfg, pr))
        out[path] = dict(logits=logits.numpy(), train={
            opt: _moe_ep_train(dict(case, state=state), cfg, pr, False, opt)
            for opt, state in tied["states"].items()})
    return out


def tp_worker(rank, world, init, inputs, out, parts):
    """The port's tensor- and sequence-parallel model on a
    (2, 4) ("data", "model") mesh of gloo ranks, in float32 (``C`` set in
    the port's model modules), under the profile keywords of the pickled
    ``inputs`` (``pure_dp``: the model axis as data) for each of its
    cases (the reference's numpy weights and the inputs, with an
    encoder's frames or a patch prefix where the arch takes them):
    ``parts`` of
    "layer" (the first layer's output and gradients, its input whole on
    every rank), "model" (``lm.forward``, ``lm.prefill`` and its cache
    shard, a ``decode_step`` from a cut random cache, the FLOPs of the
    rank's ``lm.forward`` and of the dense one over the whole batch,
    whisper's ``lm.encode`` in each), "session" (with
    "model": a ``Session`` prefill and 4 steps with its fingerprint) and
    "train" (one pot step for each optimizer of the case's states, 2
    microbatches, twice: the second time the rank at data 1, model 0
    joins each backward late; and where the case has ``tied`` weights,
    tied embeddings on the rank's shards and on the dense path,
    :func:`_tp_tied`).  Rank r
    writes ``{out}.{r}.pkl``."""
    import pickle

    from repro_torch.configs import get_smoke_config
    _join(rank, world, init)
    _f32_models()
    with open(inputs, "rb") as f:
        inputs = pickle.load(f)
    mesh, prof = _mesh_profile((2, world // 2), **inputs["profile"])
    result = {"coord": tuple(mesh.get_coordinate()),
              "profile": inputs["profile"]}
    for arch, case in inputs["cases"].items():
        cfg = get_smoke_config(arch)
        got = {}
        if "layer" in parts:
            got["layer"] = _tp_layer(case, cfg, prof)
        if "model" in parts:
            got["model"] = _tp_model(case, cfg, prof, "session" in parts)
        if "train" in parts:
            late = result["coord"] == (1, 0)
            got["train"] = {
                opt: [_moe_ep_train(dict(case, state=state), cfg, prof,
                                    d and late, opt) for d in (False, True)]
                for opt, state in case["states"].items()}
            if case["tied"]:
                got["tied"] = _tp_tied(case, cfg, prof)
        result[arch] = got
    with open(f"{out}.{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()
