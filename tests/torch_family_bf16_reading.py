"""bf16 against f32 at Mistral-7B's full width and a cut depth, on the CPU:
the JAX ``CausalTransformer`` and the port's on one set of weights.

The weights follow the builder's seeded rule (normal(0.02) projections and
embeddings, unit norm scales), made with numpy; the rows are random tokens,
every position real. Each side runs its bf16 module (f32 master weights, bf16
compute) and its f32 module over the same rows. Read at every position,
against the JAX f32 logits:

- ``logit_max_err``: the largest |bf16 logit − f32 logit|;
- ``gap_max`` and ``gap_quantiles``: how far the f32 logit of the bf16
  argmax trails the f32 best — what a bf16 greedy choice costs, the
  quantity ``chip_smoke.py``'s family parity (b) bounds.

Beside them the port's bf16 logits against JAX's bf16 logits, and the two
f32 passes against each other. This is the JAX side's own reading at the
width, independent of the port and of the card. Run from the repo root::

    JAX_PLATFORMS=cpu python -m tests.torch_family_bf16_reading --layers 4 --rows 4 --width 512

It prints one JSON line. Four layers of Mistral-7B hold 1.1B parameters:
the process peaks near 14 GiB (the numpy weights beside one framework's copy).
"""

import argparse
import dataclasses
import gc
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from trlx_tpu.models.transformer import CausalTransformer as JaxCausalTransformer
from trlx_tpu.models.transformer import config_from_spec as jax_config_from_spec
from trlx_tpu_torch.models.transformer import CausalTransformer, config_from_spec
from trlx_tpu_torch.models.weights import params_from_jax

SPEC = "builtin:mistral-7b"


def seeded_numpy_params(cfg, seed):
    """The JAX tree with the builder's distribution: unit norm scales, zero
    biases, normal(0.02) for the rest."""
    shapes = jax.eval_shape(lambda: JaxCausalTransformer(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        name = path[-1].key
        if name == "scale":
            return np.ones(leaf.shape, np.float32)
        if name == "bias":
            return np.zeros(leaf.shape, np.float32)
        x = rng.standard_normal(leaf.shape, dtype=np.float32)
        x *= 0.02
        return x

    return jax.tree_util.tree_map_with_path(make, shapes)


def reading(l16, l32):
    """bf16 logits against f32 logits, both ``[N, V]``."""
    err = np.abs(l16 - l32).max()
    pick = l16.argmax(-1)
    gap = l32.max(-1) - l32[np.arange(len(pick)), pick]
    return {"logit_max_err": float(err), "gap_max": float(gap.max()),
            "argmax_agree_frac": float((gap == 0).mean()),
            "gap_quantiles": {str(q): float(np.quantile(gap, q))
                              for q in (0.5, 0.9, 0.99, 0.999)}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    t0 = time.perf_counter()

    jcfg = dataclasses.replace(jax_config_from_spec(SPEC), num_layers=args.layers,
                               dtype=jnp.float32)
    params = seeded_numpy_params(jcfg, args.seed)
    ids = np.random.RandomState(args.seed).randint(
        0, jcfg.vocab_size, (args.rows, args.width)).astype(np.int32)
    logits = {}
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    for name, dt in (("jax_f32", jnp.float32), ("jax_bf16", jnp.bfloat16)):
        fn = jax.jit(JaxCausalTransformer(dataclasses.replace(jcfg, dtype=dt)).apply)
        out = fn({"params": jparams}, jnp.asarray(ids))
        logits[name] = np.asarray(out["logits"], np.float32).reshape(-1, jcfg.vocab_size)
        del out
    del jparams
    gc.collect()

    for name, dt in (("port_f32", torch.float32), ("port_bf16", torch.bfloat16)):
        cfg = config_from_spec(SPEC, num_layers=args.layers, dtype=dt)
        with torch.device("meta"):
            model = CausalTransformer(cfg)
        model.load_state_dict(params_from_jax(params, cfg), assign=True)
        with torch.no_grad():
            out = model.eval()(torch.tensor(ids, dtype=torch.int64))["logits"]
        logits[name] = out.float().reshape(-1, cfg.vocab_size).numpy()
        del model, out
        gc.collect()

    ref = logits["jax_f32"]
    rec = {"spec": SPEC, "num_layers": args.layers, "rows": args.rows, "width": args.width,
           "positions": int(ref.shape[0]), "seed": args.seed,
           "jax_bf16_vs_f32": reading(logits["jax_bf16"], ref),
           "port_bf16_vs_jax_f32": reading(logits["port_bf16"], ref),
           "port_bf16_vs_jax_bf16_max_err": float(np.abs(logits["port_bf16"]
                                                         - logits["jax_bf16"]).max()),
           "port_f32_vs_jax_f32_max_err": float(np.abs(logits["port_f32"] - ref).max()),
           "seconds": time.perf_counter() - t0}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
