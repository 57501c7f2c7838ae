"""The tensor-core latent decode's plain twin on the CPU.

``ref.flash_mla_decode_tc_torch`` repeats the bfloat16 latent decode
kernel's arithmetic (64-key tiles in base 2, the weights rounded to
bfloat16 before P.ckv, l summed from the float32 weights, the splits'
partial states merged in split order in base 2). On numpy-seeded inputs it
is held:
- against JAX's absorbed MLA decode (``repro.models.attention.mla_decode``
  on reduced minicpm3 in bfloat16, the port's layer run with the twin in
  the kernel's place; and the attention core of that function on its own)
  at the serving tests' bfloat16 2e-2 of the largest value;
- against the float32 plain version within the limit derived for the
  tensor-core tile (``FLASH_TC`` in ``chip_smoke.py``), whose rounding of
  the weights it shares:

      |got - want32| <= 2^-8 |want32| + (2^-8 + 2^-15) A + 2^-15,

  A the float32 plain attention over |ckv|;
- with the three planted faults of ``chip_smoke.py``'s phase 16a (the rope
  part of the scores left out, one split's keys dropped, the values read
  8 columns off) beyond that limit.
The split geometry ``mla_tc_splits`` fills about one wave of the H100's
132 SMs, and an empty trailing split weighs nothing in the merge.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import attention as J_attn
from repro_torch.configs import ARCHS
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.ops import flash_mla_decode
from repro_torch.models import api, attention

LIMIT = {"rtol": 2.0 ** -8, "arel": 2.0 ** -8 + 2.0 ** -15,
         "atol": 2.0 ** -15}
BF16_TOL = 2e-2
NAME = "minicpm3-4b"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, n, h, r, rd, seed):
    """bfloat16 q_lat, q_rope, ckv, kr from numpy; the cache parts as
    prefixes of a longer cache, as a decode passes them."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(torch.bfloat16)
    return (mk(b, 1, h, r), mk(b, 1, h, rd), mk(b, n + 7, r)[:, :n],
            mk(b, n + 7, rd)[:, :n])


def _plain32(q_lat, q_rope, ckv, kr, scale, values=None):
    """The float32 plain attention over the latent keys; values ``ckv``
    unless given (A: their absolute values)."""
    f = [x.to(torch.float32) for x in (q_lat, q_rope, ckv, kr)]
    v = f[2] if values is None else values.to(torch.float32)
    return ref.sdpa(torch.cat(f[:2], -1), ref.mla_keys(f[2], f[3]),
                    v[:, :, None], None, scale)


def _over_limit(got, xs, scale):
    want = _plain32(*xs, scale)
    a32 = _plain32(*xs, scale, values=xs[2].abs())
    lim = LIMIT["rtol"] * want.abs() + LIMIT["arel"] * a32 + LIMIT["atol"]
    return float(((got.to(torch.float32) - want).abs() / lim).max())


# the kernel's widths (r a multiple of 64, rd 32 or 64) and, for the
# arithmetic alone, reduced minicpm3's (32 + 8) and a ragged one
SHAPES = [(2, 1, 4, 32, 8), (2, 77, 4, 32, 8), (1, 300, 40, 256, 32),
          (3, 1029, 40, 256, 32), (2, 333, 16, 256, 32),
          (1, 700, 128, 256, 64), (1, 70, 20, 72, 8),
          (4, 2112, 40, 256, 32), (2, 400, 40, 64, 64), (1, 129, 8, 192, 32)]


@pytest.mark.parametrize("b,n,h,r,rd", SHAPES)
def test_tc_twin_within_derived_limit(b, n, h, r, rd):
    """The twin at the kernel's own splits: ragged n, one split and many,
    16 to 128 heads, minicpm3's widths (40 heads over 256 + 32)."""
    xs = _inputs(b, n, h, r, rd, seed=n + h)
    n_split = FA.mla_tc_splits(b, h, n)
    got = ref.flash_mla_decode_tc_torch(*xs, 0.1, n_split)
    assert got.dtype == torch.bfloat16 and got.shape == (b, 1, h, r)
    assert _over_limit(got, xs, 0.1) <= 1.0


@pytest.mark.parametrize("b,n,h,r,rd", SHAPES[:6])
def test_tc_twin_matches_jax_absorbed_core(b, n, h, r, rd):
    """Against the attention core of JAX's absorbed ``mla_decode``, spelled
    as it is there (scores summed in bfloat16, scaled in float32, softmax,
    weights in bfloat16 times ckv), at 2e-2 of the largest value."""
    xs = _inputs(b, n, h, r, rd, seed=7 * n + h)
    jq_lat, jq_rope, jckv, jkr = (jnp.asarray(x.float().numpy(),
                                              jnp.bfloat16) for x in xs)
    logits = (jnp.einsum("bthr,bsr->bhts", jq_lat, jckv)
              + jnp.einsum("bthd,bsd->bhts", jq_rope, jkr))
    w = jax.nn.softmax(logits.astype(jnp.float32) * 0.1, axis=-1).astype(
        jnp.bfloat16)
    want = np.asarray(jnp.einsum("bhts,bsr->bthr", w, jckv), np.float32)
    got = ref.flash_mla_decode_tc_torch(*xs, 0.1,
                                        FA.mla_tc_splits(b, h, n))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("pos", [0, 5, 11])
def test_absorbed_layer_with_twin_matches_jax(monkeypatch, pos):
    """One reduced minicpm3 MLA layer in bfloat16, absorbed decode at
    position ``pos`` over caches filled from numpy: the port's
    ``mla_decode`` with the twin in the latent decode kernel's place
    against JAX's ``mla_decode``; output and written caches at 2e-2."""
    jcfg = J_ARCHS[NAME].reduced(dtype="bfloat16")
    cfg = ARCHS[NAME].reduced(dtype="bfloat16")
    assert cfg.decode_absorb and jcfg.decode_absorb
    jp = J_attn.init_mla(jax.random.PRNGKey(3), jcfg)
    p = api.caches_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(pos)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(2, 12, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(2, 12, cfg.qk_rope_dim)).astype(np.float32)
    calls = []

    def twin(q_lat, q_rope, c, k, scale):
        calls.append(q_lat.dtype)
        return ref.flash_mla_decode_tc_torch(
            q_lat, q_rope, c, k, scale,
            FA.mla_tc_splits(q_lat.shape[0], q_lat.shape[2], c.shape[1]))

    monkeypatch.setattr(attention, "flash_mla_decode", twin)
    bf = torch.bfloat16
    cache = {"ckv": torch.from_numpy(ckv).to(bf),
             "kr": torch.from_numpy(kr).to(bf)}
    with torch.no_grad():
        out, cache = attention.mla_decode(p, torch.from_numpy(x).to(bf),
                                          cache, pos, cfg)
    jout, jcache = J_attn.mla_decode(
        jp, jnp.asarray(x, jnp.bfloat16),
        {"ckv": jnp.asarray(ckv, jnp.bfloat16),
         "kr": jnp.asarray(kr, jnp.bfloat16)}, pos, jcfg)
    assert calls == [bf]
    for got, want in ((out, jout), (cache["ckv"], jcache["ckv"]),
                      (cache["kr"], jcache["kr"])):
        w = np.asarray(jnp.asarray(want, jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), w, rtol=BF16_TOL,
                                   atol=BF16_TOL * float(np.abs(w).max()))


def test_planted_faults_exceed_the_limit():
    """At minicpm3's widths over 2,112 positions: the twin within the
    limit; the rope part of the scores left out, one split's keys dropped
    and the values read 8 columns off each beyond it."""
    b, n, h, r, rd = 4, 2112, 40, 256, 32
    xs = _inputs(b, n, h, r, rd, seed=27)
    n_split = FA.mla_tc_splits(b, h, n)
    chunk = ref.split_chunk(n, n_split)
    assert n_split >= 4
    assert _over_limit(ref.flash_mla_decode_tc_torch(*xs, 0.1, n_split),
                       xs, 0.1) <= 1.0
    f = [x.to(torch.float32) for x in xs]
    q, keys = torch.cat(f[:2], -1), ref.mla_keys(f[2], f[3])
    kpos = torch.arange(n)[None, None, :]
    faults = {
        "rope dropped": ref.flash_mla_decode_tc_torch(
            xs[0], torch.zeros_like(xs[1]), xs[2], xs[3], 0.1, n_split),
        "split 3 dropped": ref.sdpa(
            q, keys, f[2][:, :, None],
            ~((kpos >= 3 * chunk) & (kpos < 4 * chunk)), 0.1),
        "values 8 columns off": ref.sdpa(
            q, keys, torch.roll(f[2], 8, -1)[:, :, None], None, 0.1)}
    for name, faulty in faults.items():
        assert _over_limit(faulty.to(torch.bfloat16), xs, 0.1) > 1.0, name


def test_empty_trailing_split_weighs_nothing():
    """Five 64-key tiles in four splits of two tiles: the last split is
    empty (m = -1e30, l = 0) and the merge gives it weight 0."""
    xs = _inputs(2, 320, 8, 32, 8, seed=5)
    assert ref.split_chunk(320, 4) * 3 >= 320
    four = ref.flash_mla_decode_tc_torch(*xs, 0.1, 4)
    assert _over_limit(four, xs, 0.1) <= 1.0
    assert torch.isfinite(four.float()).all()


@pytest.mark.parametrize("b,h,n", [(4, 40, 32_832), (1, 40, 32_832),
                                   (4, 128, 32_832), (32, 40, 4096),
                                   (4, 40, 1), (4, 40, 700), (200, 16, 9000),
                                   (2, 40, 2112)])
def test_tc_split_geometry(b, h, n):
    """About one wave of blocks (b ceil(h / 64) a split, 132 SMs), at least
    one split, each split at least 128 keys where there are two, and at
    most the merge's 1,024; at minicpm3's cell 33 splits of 1,024 keys."""
    s = FA.mla_tc_splits(b, h, n)
    blocks = b * -(-h // FA.MLA_TC_HEADS)
    assert 1 <= s <= FA.MLA_TC_MAX_SPLITS
    assert s == 1 or n // s >= FA.SPLIT_MIN_KEYS
    if n // FA.SPLIT_MIN_KEYS >= round(FA.MLA_TC_BLOCKS / blocks) >= 1:
        assert abs(blocks * s - FA.MLA_TC_BLOCKS) <= blocks / 2
    chunk = ref.split_chunk(n, s)
    assert chunk % 64 == 0 and s * chunk >= n
    assert s * chunk - n < chunk + 64 * s     # only tiles' rounding left
    if (b, h, n) == (4, 40, 32_832):
        assert (s, chunk) == (33, 1024)


@pytest.mark.parametrize("r,rd,tc", [(256, 32, True), (64, 64, True),
                                      (192, 32, True), (32, 8, False),
                                      (256, 16, False), (72, 32, False),
                                      (512, 64, True), (320, 64, False)])
def test_dispatch_by_dtype_and_widths(r, rd, tc):
    """bfloat16 at the tensor-core kernel's widths (r 64, 128, 192, 256 or
    512, rd 32 or 64; minicpm3's 256 + 32, deepseek-v2's 512 + 64) takes
    ``"mla_decode_tc"`` and its splits; float32, and bfloat16 at other
    widths (r 320 among them), the CUDA-core kernel."""
    ql, qr = torch.zeros(2, 1, 4, r, dtype=torch.bfloat16), torch.zeros(
        2, 1, 4, rd, dtype=torch.bfloat16)
    assert FA.mla_tc_widths(r, rd) == tc
    want = "mla_decode_tc" if tc else "mla_decode"
    assert FA.mla_path_of(ql, qr) == want
    assert FA.mla_path_of(ql.float(), qr.float()) == "mla_decode"
    assert FA.mla_splits_of(ql, qr, 5000) == (
        FA.mla_tc_splits(2, 4, 5000) if tc else FA.mla_splits(2, 4, 5000, r))


def test_cpu_tensors_run_the_plain_version():
    """On CPU tensors the wrapper runs the plain version, in both dtypes,
    and counts nothing; the CUDA launcher refuses them."""
    xs = _inputs(2, 100, 4, 256, 32, seed=1)
    assert "mla_decode_tc" in FA.PATHS
    before = dict(FA.flash_attention_cuda.launches_by_path)
    got = flash_mla_decode(*xs, 0.1)
    assert FA.flash_attention_cuda.launches_by_path == before
    torch.testing.assert_close(got, ref.flash_mla_decode_torch(
        *xs, 0.1, FA.mla_splits(2, 4, 100)))
    f32 = [x.float() for x in xs]
    torch.testing.assert_close(flash_mla_decode(*f32, 0.1),
                               ref.flash_mla_decode_torch(
                                   *f32, 0.1, FA.mla_splits(2, 4, 100)))
    with pytest.raises(ValueError, match="CUDA device"):
        FA.flash_mla_decode_cuda(*xs, 0.1)
