"""Sharded serving (``launch.sharded.ShardedServeStep``) on a gloo (2, 2)
mesh of 4 CPU ranks vs one process's port and the JAX package's
``make_prefill_step``/``make_serve_step``.

Each config, reduced and float32 (qwen3-32b: GQA with qk-norm; minicpm3-4b:
MLA's latent caches, gathered whole; hymba-1.5b with an 8-position window:
a global layer, a windowed ring and the Mamba state; whisper-large-v3:
the decoder's self and cross attention over 24 frames), prefills a batch
of 4 prompts of 6 tokens (2 rows a dp rank) and decodes 14 greedy steps
into caches of 24 positions placed by ``cache_pspecs``: a full-attention
layer's k/v split over ``model`` in blocks [0, 12) and [12, 24), so the
first 6 steps run while the second block is still empty, and the
positions then cross into it. whisper's self caches are 448 slots, split
[0, 224) and [224, 448), so its second self block stays empty; its cross
caches' blocks of frames are both full. The sharded decode takes ``pos`` as the
sequence's own position and merges the ``model`` ranks' blocks by
log-sum-exp; the prefill's caches come back placed by ``cache_pspecs``,
are gathered and handed into the decode caches (``api.decode_caches``),
then placed again.

Tokens must equal one process's and JAX's at every step, on every rank;
the last logits are held to ``tests/test_torch_serve.py``'s float32
tolerance (rtol 1e-5, an atol of 1e-5 times the largest reference
value: the sums over ``model`` and over the blocks change the order of
float32 sums). A planted fault, the last ``model`` rank's block left out
of the merge (``layer_gather.merge_parts``), must leave the tolerance
once the positions reach that block. The ranks are one spawn for the
module (this file run as ``python tests/test_torch_sharded_serve.py
--ranks DIR``).

The plain merge's log-sum-exp (``ref.flash_decode_split_torch(...,
lse=True)``, the twin of the split decode's merge) is held to a float64
log-sum-exp of the same scores.
"""
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.launch import steps as J_steps
from repro.models import api as J
from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref
from repro_torch.launch import sharded, steps
from repro_torch.models import api
from repro_torch.parallel import layer_gather
from repro_torch.parallel.sharding import placements

ROOT = Path(__file__).resolve().parents[1]
B, PROMPT, SEQ = 4, 6, 24
FRAMES = 24
N_STEPS = SEQ - PROMPT - 4              # positions 6 .. 19
TOL = 1e-5
CONFIGS = {"qwen3-32b": {}, "minicpm3-4b": {},
           "hymba-1.5b": {"sliding_window": 8, "chunk_size": 8},
           "whisper-large-v3": {}}
RUNS = {**{name: (name, False) for name in CONFIGS},
        "qwen3-32b-fault": ("qwen3-32b", True)}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name, archs=ARCHS):
    return archs[name].reduced(dtype="float32", **CONFIGS[name])


def _batch(cfg) -> dict:
    """The prompts (numpy): tokens, and the encoder-decoder's frames."""
    rng = np.random.default_rng(11)
    out = {"tokens": rng.integers(0, cfg.vocab, size=(B, PROMPT))}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.normal(size=(B, FRAMES, cfg.d_model)).astype(
            np.float32)
    return out


def _torch(batch) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# -- the ranks ----------------------------------------------------------------

def _dropped_last(outs, lses, _real=layer_gather.merge_parts):
    return _real(outs[:-1], lses[:-1])


def _serve_sharded(cfg, params, prompts, mesh, rules):
    """Prefill, the hand-off, then ``N_STEPS`` decode steps on this rank:
    (its token rows at each step, the whole last logits at each step)."""
    shape = api.ShapeSpec("serve", PROMPT, B, "prefill")
    batch = _torch(prompts)
    p = sharded.shard(params, mesh, steps.param_pspecs(params, rules))
    b = sharded.shard(batch, mesh, steps.batch_pspecs(batch, mesh, shape))
    pre = sharded.ShardedServeStep(cfg, mesh, rules, "prefill",
                                   keep_logits=True)
    tok, pc = pre(p, b)
    want = {}
    steps.map_with_path(lambda path, spec: want.__setitem__(path, spec),
                        steps.cache_pspecs(pc, mesh, shape))
    for path, d in T.leaves_with_paths(pc):
        assert tuple(d.placements) == placements(mesh, want[path],
                                                 d.ndim), path
    whole = api.decode_caches(cfg, sharded.gather_tree(pc), batch, N_STEPS
                              + 4)
    caches = sharded.shard(whole, mesh, steps.cache_pspecs(whole, mesh,
                                                           shape))
    dec = sharded.ShardedServeStep(cfg, mesh, rules, "decode",
                                   keep_logits=True)
    toks_out, logits = [tok.numpy()], [pre.logits.numpy()]
    for s in range(N_STEPS):
        tok, out = dec(p, caches, tok, PROMPT + s)
        assert out is caches
        toks_out.append(tok.numpy())
        logits.append(dec.logits.numpy())
    return np.concatenate(toks_out, 1), np.stack(logits)


def _rank_body(rank, world, store, out_dir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = make_test_mesh(2, 2)
        rules = steps.rules_for(mesh, api.ShapeSpec("s", PROMPT, B,
                                                    "prefill"))
        for run, (name, fault) in RUNS.items():
            state = torch.load(os.path.join(out_dir, f"{name}.pt"),
                               weights_only=False)
            real, combine = layer_gather.merge_parts, layer_gather.combine
            merges = []

            def counted(*a, _real=combine):
                merges.append(a[0] is not None)
                return _real(*a)
            layer_gather.merge_parts = _dropped_last if fault else real
            layer_gather.combine = counted
            try:
                toks, logits = _serve_sharded(_cfg(name), state["params"],
                                              state["prompts"], mesh, rules)
            finally:
                layer_gather.merge_parts = real
                layer_gather.combine = combine
            np.savez(os.path.join(out_dir, f"{run}-rank{rank}.npz"),
                     tokens=toks, logits=logits, merges=np.asarray(merges),
                     coord=np.asarray(mesh.get_coordinate()))
        np.save(os.path.join(out_dir, f"argmax-rank{rank}.npy"),
                _argmax_ties(mesh, rules))
    finally:
        dist.destroy_process_group()


def _argmax_ties(mesh, rules) -> np.ndarray:
    """``layer_gather.argmax`` over the two ``model`` ranks' blocks of a
    vocabulary of 256 (columns [0, 128) and [128, 256)): row 0 ties at
    5 in columns 3 and 129, row 1 has its largest in block 1 only, row 2
    ties at 7 in columns 140 and 150 within block 1, row 3 ties in every
    column."""
    cfg = _cfg("qwen3-32b")
    params = api.init_fn(cfg, "cpu")(0)
    p = sharded.shard(params, mesh, steps.param_pspecs(params, rules))
    plan = sharded._plan(cfg, mesh, p, False, None)
    lo, n = plan.v_offset, plan.v_local
    whole = torch.zeros(4, 2 * n)
    whole[0, 3] = whole[0, 129] = 5.0
    whole[1, 200] = 2.0
    whole[2, 140] = whole[2, 150] = 7.0
    with layer_gather.installed(plan):
        got = layer_gather.argmax(whole[:, lo:lo + n].contiguous())
    return got.numpy()


def _spawn(out_dir):
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_body, args=(4, os.path.join(tmp, "store"), out_dir),
                 nprocs=4)


# -- the references -----------------------------------------------------------

def _models(name):
    jcfg, cfg = _cfg(name, J_ARCHS), _cfg(name)
    jparams = J.init_fn(jcfg)(jax.random.PRNGKey(3))
    params = api.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _single(cfg, params, prompts):
    batch = _torch(prompts)
    tok, pre = steps.make_prefill_step(cfg)(params, batch)
    caches = api.decode_caches(cfg, pre, batch, N_STEPS + 4)
    got = [tok.numpy()]
    for s in range(N_STEPS):
        tok, caches = steps.make_serve_step(cfg)(params, caches, tok,
                                                 PROMPT + s)
        got.append(tok.numpy())
    return np.concatenate(got, 1)


def _jax(jcfg, cfg, jparams, prompts):
    """JAX's steps; its decode caches the port's hand-off of its prefill
    caches (``api.decode_caches``), crossed back as numpy."""
    jb = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
          for k, v in prompts.items()}
    jtok, jpre = jax.jit(J_steps.make_prefill_step(jcfg))(jparams, jb)
    pre = api.caches_from_jax(jax.tree.map(np.asarray, jpre), "cpu")
    caches = api.decode_caches(cfg, pre, _torch(prompts), N_STEPS + 4)
    jc = jax.tree.map(jnp.asarray, api.caches_to_numpy(caches))
    serve = jax.jit(J_steps.make_serve_step(jcfg))
    dfn = jax.jit(J.decode_fn(jcfg))
    got, logits = [np.asarray(jtok)], []
    for s in range(N_STEPS):
        logits.append(np.asarray(dfn(jparams, jc, jtok,
                                     jnp.int32(PROMPT + s))[0][:, -1]))
        jtok, jc = serve(jparams, jc, jtok, jnp.int32(PROMPT + s))
        got.append(np.asarray(jtok))
    return np.concatenate(got, 1), np.stack(logits)


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as tmp:
        refs = {}
        for name in CONFIGS:
            jcfg, cfg, jparams, params = _models(name)
            prompts = _batch(cfg)
            torch.save({"params": params, "prompts": prompts},
                       os.path.join(tmp, f"{name}.pt"))
            refs[name] = {"single": _single(cfg, params, prompts),
                          "jax": _jax(jcfg, cfg, jparams, prompts)}
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.Popen([sys.executable, __file__, "--ranks", tmp],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
        _, err = proc.communicate(timeout=400)
        assert proc.returncode == 0, err[-4000:]
        got = {run: [dict(np.load(os.path.join(tmp, f"{run}-rank{r}.npz")))
                     for r in range(4)] for run in RUNS}
        got["argmax"] = [np.load(os.path.join(tmp, f"argmax-rank{r}.npy"))
                         for r in range(4)]
    return refs, got


def test_argmax_across_vocab_blocks_takes_the_lower_index_on_a_tie(ranks):
    """The greedy token over the vocabulary's blocks: the largest value,
    the lower index on a tie, within a block and across blocks, as
    ``jnp.argmax`` picks; every rank the same."""
    for got in ranks[1]["argmax"]:
        np.testing.assert_array_equal(got, [3, 200, 140, 0])
    want = np.zeros((4, 256), np.float32)
    want[0, [3, 129]], want[1, 200], want[2, [140, 150]] = 5, 2, 7
    np.testing.assert_array_equal(np.asarray(jnp.argmax(want, -1)),
                                  [3, 200, 140, 0])


def _whole_tokens(outs) -> np.ndarray:
    """The ranks' token rows in batch order (dp coordinate major)."""
    rows = {}
    for o in outs:
        d, m = o["coord"]
        if m:
            np.testing.assert_array_equal(o["tokens"], rows[d])
        rows.setdefault(int(d), o["tokens"])
    return np.concatenate([rows[d] for d in sorted(rows)])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_serve_equals_one_process_and_jax(ranks, name):
    refs, got = ranks
    outs = sorted(got[name], key=lambda o: tuple(o["coord"]))
    toks = _whole_tokens(outs)
    np.testing.assert_array_equal(toks, refs[name]["single"])
    np.testing.assert_array_equal(toks, refs[name]["jax"][0])
    for a, o in zip(outs[::2], outs[1::2]):   # a dp block's model ranks
        np.testing.assert_array_equal(o["logits"], a["logits"])
    # the full-attention layers merge the model ranks' blocks every step
    # (MLA's latent caches are gathered whole); model rank 1's block holds
    # a filled position from position 12 on (whisper: each layer's self
    # attention, whose rank-1 block stays empty, then its cross attention
    # over a full block of frames)
    second = PROMPT + np.arange(N_STEPS)[:, None] >= SEQ // 2
    want = {"qwen3-32b": np.repeat(second, 2, 1), "minicpm3-4b": None,
            "hymba-1.5b": second,
            "whisper-large-v3": np.tile([False, True], (N_STEPS, 2))}[name]
    for o in outs:
        if want is None:
            assert o["merges"].size == 0
        else:
            filled = want if o["coord"][1] else np.ones_like(want)
            np.testing.assert_array_equal(
                o["merges"].reshape(want.shape), filled)
    jl = refs[name]["jax"][1]              # (steps, B, V)
    for o in outs:
        d = int(o["coord"][0])
        want = jl[:, 2 * d:2 * d + 2]
        np.testing.assert_allclose(o["logits"][1:], want, rtol=TOL,
                                   atol=TOL * float(np.abs(want).max()))


def test_a_block_left_out_of_the_merge_leaves_the_tolerance(ranks):
    refs, got = ranks
    jl = refs["qwen3-32b"]["jax"][1]
    out = got["qwen3-32b-fault"][0]
    d = int(out["coord"][0])
    want = jl[:, 2 * d:2 * d + 2]
    gap = np.abs(out["logits"][1:] - want) / (
        TOL * (np.abs(want) + float(np.abs(want).max())))
    steps_pos = PROMPT + np.arange(N_STEPS)
    before = gap[steps_pos < SEQ // 2].max()
    after = gap[steps_pos >= SEQ // 2].max()
    assert before <= 1.0, before           # block 1 empty: nothing dropped
    assert after > 10.0, after


@pytest.mark.parametrize("n,h,hkv,d,n_split", [(1, 4, 2, 16, 1),
                                               (200, 8, 2, 64, 3),
                                               (700, 4, 4, 128, 5)])
def test_plain_merge_lse_is_the_float64_logsumexp(n, h, hkv, d, n_split):
    """The merge's lse against a float64 log-sum-exp of the same float32
    scores: the float32 merge rounds the score once (the dot of D terms,
    within D u |q||k| scale of the float64 one), the split sums of n
    exponentials (n u relative, so n u absolute in the log) and the merge's
    few operations; the limit is (D + n + 8) u of max(1, |lse|)."""
    g = torch.Generator().manual_seed(n + d)
    q = torch.randn(2, 1, h, d, generator=g)
    k = torch.randn(2, n, hkv, d, generator=g)
    v = torch.randn(2, n, hkv, d, generator=g)
    scale = 1.0 / math.sqrt(d)
    out, lse = ref.flash_decode_split_torch(q, k, v, scale, n_split,
                                            lse=True)
    assert lse.shape == (2, h) and lse.dtype == torch.float32
    G = h // hkv
    s = torch.einsum("bhgd,bshd->bhgs", q.double().reshape(2, hkv, G, d),
                     k.double()) * scale
    want = torch.logsumexp(s, -1).reshape(2, h)
    lim = (d + n + 8) * 2.0 ** -24 * torch.clamp(want.abs(), min=1.0)
    assert bool(((lse.double() - want).abs() <= lim).all())
    np.testing.assert_array_equal(
        out.numpy(), ref.flash_decode_split_torch(q, k, v, scale,
                                                  n_split).numpy())
    # the wrapper's CPU path is the same twin
    o2, l2 = flash_ops.flash_decode_lse(q, k, v, scale)
    torch.testing.assert_close(o2, out, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(l2, lse, rtol=1e-6, atol=1e-6)


def test_merging_two_blocks_by_lse_is_the_whole_decode():
    """``merge_parts`` of two blocks' (out, lse) is the decode over both
    blocks' keys (float32 rounding), and an empty block (lse -inf) adds
    nothing."""
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 1, 4, 32, generator=g)
    k = torch.randn(2, 90, 2, 32, generator=g)
    v = torch.randn(2, 90, 2, 32, generator=g)
    whole = ref.flash_decode_split_torch(q, k, v, 0.2, 1)
    parts = [ref.flash_decode_split_torch(q, k[:, a:b], v[:, a:b], 0.2, 1,
                                          lse=True)
             for a, b in ((0, 40), (40, 90))]
    outs = torch.stack([o[:, 0] for o, _ in parts])
    lses = torch.stack([s for _, s in parts])
    got = layer_gather.merge_parts(outs, lses)
    torch.testing.assert_close(got, whole[:, 0], rtol=1e-5, atol=1e-6)
    first, lse = parts[0][0][:, 0], parts[0][1]
    empty = layer_gather.merge_parts(
        torch.stack([first, torch.zeros_like(first)]),
        torch.stack([lse, torch.full_like(lse, -math.inf)]))
    torch.testing.assert_close(empty, first, rtol=1e-6, atol=1e-7)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ranks"]:
        _spawn(sys.argv[2])
    else:
        sys.exit("usage: test_torch_sharded_serve.py --ranks OUT_DIR")
