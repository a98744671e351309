"""The JAX side of tests/test_torch_dryrun.py: XLA's memory analysis of the
reference's dry-run cells on a small forced host mesh.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tests/_dryrun_jax.py D M ARCH:SHAPE [ARCH:SHAPE ...]

Each cell is lowered and compiled as `repro.launch.dryrun.run_cell` does
it, with the smoke config of ARCH, the JAX package's own `shardings_for`,
`param_specs`, `state_specs` and `input_specs` and
`make_rules(mesh, overrides=overrides_for(cfg, kind))`, on a (D, M)
("data", "model") mesh, with `keep_unused=True` so that no argument is
pruned. Prints one JSON object: {"ARCH:SHAPE": {"argument_size_in_bytes",
"output_size_in_bytes", "alias_size_in_bytes"}}.

`shard_sums` (imported by the tests, no devices needed) gives the bytes a
rank of a production mesh holds of each argument kind: the sum over the
reference's own spec trees and `eval_shape` leaves of
`NamedSharding(AbstractMesh, spec).shard_shape(shape)` x itemsize.
"""

import json
import sys


def memory_of(arch, shape, mesh):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs.registry import get_config
    from repro.launch.train import make_train_step, shardings_for
    from repro.models.api import SHAPES, build_model
    from repro.optim import adamw
    from repro.parallel.sharding import make_rules, overrides_for

    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    scell = SHAPES[shape]
    seq_sharded = bool(scell.get("seq_sharded"))
    rules = make_rules(mesh, overrides=overrides_for(cfg, scell["kind"]))
    to_sh = lambda tree: jax.tree.map(
        lambda s: NamedSharding(mesh, s), tree,
        is_leaf=lambda x: isinstance(x, P))
    pshapes = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0)))
    with mesh:
        if scell["kind"] in ("train", "prefill"):
            oshapes = jax.eval_shape(lambda: adamw.init(pshapes))
            psh, osh = shardings_for(model, mesh, rules, pshapes, oshapes)
            batch = model.input_specs(shape)
            bsh = {k: NamedSharding(mesh, rules.spec(
                *(("batch",) + (None,) * (len(v.shape) - 1)), sizes=v.shape))
                for k, v in batch.items()}
            if scell["kind"] == "train":
                step = make_train_step(model, adamw.AdamWConfig(), mesh=mesh,
                                       rules=rules)
                f32 = lambda t: jax.tree.map(
                    lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), t)
                lowered = jax.jit(
                    step, in_shardings=(psh, osh, bsh),
                    out_shardings=(psh, osh, None), donate_argnums=(0, 1),
                    keep_unused=True).lower(
                        pshapes, adamw.OptState(
                            m=f32(pshapes), v=f32(pshapes),
                            count=jax.ShapeDtypeStruct((), jnp.int32)),
                        batch)
            else:
                def prefill(params, b):
                    kw = {k: b[k] for k in ("patch_embeds", "frames") if k in b}
                    return model.forward_train(params, b["tokens"], mesh=mesh,
                                               rules=rules, **kw)
                lowered = jax.jit(prefill, in_shardings=(psh, bsh),
                                  out_shardings=None,
                                  keep_unused=True).lower(pshapes, batch)
        else:
            b, n = scell["global_batch"], scell["seq_len"]
            psh = to_sh(model.param_specs(rules))
            ssh = to_sh(model.state_specs(rules, batch=b, max_len=n,
                                          seq_sharded=seq_sharded))
            tok = NamedSharding(mesh, rules.spec("batch", sizes=(b,)))

            def serve(params, state, tokens):
                return model.serve_step(params, state, tokens, mesh=mesh,
                                        rules=rules, seq_sharded=seq_sharded)

            lowered = jax.jit(serve, in_shardings=(psh, ssh, tok),
                              out_shardings=(None, ssh), donate_argnums=(1,),
                              keep_unused=True).lower(
                                  pshapes, model.decode_state_specs(shape),
                                  jax.ShapeDtypeStruct((b,), jnp.int32))
        mem = lowered.compile().memory_analysis()
    return {k: int(getattr(mem, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes")}


_PSHAPES = {}


def _param_shapes(arch):
    import jax
    from repro.configs.registry import get_config
    from repro.models.api import build_model
    if arch not in _PSHAPES:
        model = build_model(get_config(arch))
        _PSHAPES[arch] = jax.eval_shape(
            lambda: model.init_params(jax.random.PRNGKey(0)))
    return _PSHAPES[arch]


def shard_sums(arch, shape, multi_pod):
    """{"params", "moments", "state", "inputs"}: one rank's bytes of the
    reference's cell on the production mesh, from its specs alone."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs.registry import get_config
    from repro.models.api import SHAPES, build_model
    from repro.optim import adamw
    from repro.parallel.sharding import abstract_mesh, make_rules, overrides_for

    cfg = get_config(arch)
    model = build_model(cfg)
    mesh = (abstract_mesh((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else abstract_mesh((16, 16), ("data", "model")))
    s = SHAPES[shape]
    rules = make_rules(mesh, overrides=overrides_for(cfg, s["kind"]))

    def nbytes(spec, x, dtype=None):
        n = int(np.prod(NamedSharding(mesh, spec).shard_shape(x.shape)))
        return n * jnp.dtype(dtype or x.dtype).itemsize

    def total(specs, shapes, dtype=None):
        sp = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
        xs = jax.tree.leaves(shapes)
        assert len(sp) == len(xs)
        return sum(nbytes(a, b, dtype) for a, b in zip(sp, xs))

    pshapes = _param_shapes(arch)
    pspecs = model.param_specs(rules)
    out = {"params": total(pspecs, pshapes), "moments": 0, "state": 0}
    b = s["global_batch"]
    if s["kind"] == "decode":
        sspecs = model.state_specs(rules, batch=b, max_len=s["seq_len"],
                                   seq_sharded=bool(s.get("seq_sharded")))
        out["state"] = total(sspecs, model.decode_state_specs(shape))
        out["inputs"] = nbytes(rules.spec("batch", sizes=(b,)),
                               jax.ShapeDtypeStruct((b,), jnp.int32))
        return out
    ins = model.input_specs(shape)
    out["inputs"] = sum(nbytes(rules.spec(
        "batch", *(None,) * (len(v.shape) - 1), sizes=v.shape), v)
        for v in ins.values())
    if s["kind"] == "train":
        zspecs = adamw.zero1_specs(pspecs, rules, sizes_tree=pshapes)
        out["moments"] = 2 * total(zspecs, pshapes, jnp.float32) + 4
    return out


def main(argv):
    import jax
    from repro.launch.mesh import make_mesh
    d, m = int(argv[0]), int(argv[1])
    mesh = make_mesh((d, m), ("data", "model"))
    assert len(jax.devices()) >= d * m
    out = {}
    for cell in argv[2:]:
        arch, shape = cell.split(":")
        out[cell] = memory_of(arch, shape, mesh)
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
