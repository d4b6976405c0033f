"""The port's random stream (``ops/random.py``, ``ops/kernels/threefry.py``)
against ``jax.random`` on the CPU, bit for bit.

The reference draws its sampled Newton columns with ``jax.random`` under
its default Threefry-2x32 implementation (JAX 0.9: the partitionable
split and bits). The port computes the same hash in uint32 arithmetic
carried in int64 tensors; on the card the CUDA kernel
(``csrc/threefry.cu``) is held to this plain version by ``chip_smoke.py``.
Every comparison here is exact: keys, bits and drawn indices equal, index
for index (``choice_without_replacement`` keeps the reference's order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from pycmf_tpu_torch.ops import random as trandom
from pycmf_tpu_torch.ops.kernels import threefry as tthreefry
from pycmf_tpu_torch.ops.kernels.policy import launch_counts

# Random123's known-answer vectors, as JAX's own random_test.py takes them
KNOWN = [
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000),
     (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
]


def _key(words):
    return torch.tensor(list(words), dtype=torch.int64)


def _np(t):
    return np.asarray(t.numpy(), dtype=np.uint64)


def _jkey(key):
    return np.asarray(jax.random.key_data(key), dtype=np.uint64) \
        if jnp.issubdtype(key.dtype, jax.dtypes.prng_key) \
        else np.asarray(key, dtype=np.uint64)


@pytest.mark.parametrize("key,count,want", KNOWN,
                         ids=["zeros", "ones", "pi"])
def test_threefry_known_answers(key, count, want):
    """The Random123 vectors, and the installed JAX's hash of them."""
    got = tthreefry.threefry2x32_ref(_key(key), (torch.tensor(count[0]),
                                                 torch.tensor(count[1])))
    assert (int(got[0]), int(got[1])) == want
    ref = jprng.threefry_2x32(jnp.asarray(key, jnp.uint32),
                              jnp.asarray(count, jnp.uint32))
    assert tuple(int(v) for v in np.asarray(ref)) == want


def test_threefry_matches_jax_on_random_pairs():
    """1000 random keys and counter pairs: the hash's two words equal the
    reference lowering's (JAX's threefry2x32 primitive on the pairs)."""
    rs = np.random.RandomState(0)
    keys = rs.randint(0, 2 ** 32, size=(1000, 2), dtype=np.uint64)
    ctrs = rs.randint(0, 2 ** 32, size=(1000, 2), dtype=np.uint64)
    for i in range(0, 1000, 250):
        for j in range(i, i + 250):
            k, c = keys[j], ctrs[j]
            y0, y1 = tthreefry.threefry2x32_ref(
                torch.from_numpy(k.astype(np.int64)),
                (torch.tensor(int(c[0])), torch.tensor(int(c[1]))))
            want = jprng.threefry2x32_p.bind(
                jnp.uint32(k[0]), jnp.uint32(k[1]), jnp.uint32(c[0]),
                jnp.uint32(c[1]))
            assert (int(y0), int(y1)) == tuple(int(v) for v in want)


def test_threefry_is_vectorised_over_counters():
    """One call over a vector of counter pairs equals the pairs one by
    one (the plain version's broadcasting)."""
    rs = np.random.RandomState(1)
    key = torch.from_numpy(rs.randint(0, 2 ** 32, 2).astype(np.int64))
    c = torch.from_numpy(rs.randint(0, 2 ** 32, (2, 64)).astype(np.int64))
    y0, y1 = tthreefry.threefry2x32_ref(key, (c[0], c[1]))
    want = jprng.threefry2x32_p.bind(
        jnp.uint32(int(key[0])), jnp.uint32(int(key[1])),
        jnp.asarray(c[0].numpy(), jnp.uint32),
        jnp.asarray(c[1].numpy(), jnp.uint32))
    np.testing.assert_array_equal(_np(y0), np.asarray(want[0], np.uint64))
    np.testing.assert_array_equal(_np(y1), np.asarray(want[1], np.uint64))


SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 32 + 7, -1, -(2 ** 40),
         int(np.random.RandomState(5).get_state()[1][0])]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    """PRNGKey under x64, the tests' mode: the seed's int64 words (a
    negative seed in two's complement; a RandomState's first word)."""
    np.testing.assert_array_equal(_np(trandom.prng_key(seed)),
                                  _jkey(jax.random.PRNGKey(seed)))


def test_prng_key_refuses_past_int64():
    with pytest.raises(OverflowError):
        trandom.prng_key(2 ** 63)
    with pytest.raises(ValueError, match="uint32"):
        trandom.fold_in(trandom.prng_key(0), -1)


@pytest.mark.parametrize("seed", SEEDS[:4] + SEEDS[-1:])
@pytest.mark.parametrize("data", [0, 1, 2 ** 32 - 1])
def test_fold_in_matches_jax(seed, data):
    got = trandom.fold_in(trandom.prng_key(seed), data)
    want = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    np.testing.assert_array_equal(_np(got), _jkey(want))


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_split_matches_jax(n):
    key = trandom.fold_in(trandom.prng_key(3), 11)
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    np.testing.assert_array_equal(_np(trandom.split(key, n)),
                                  _jkey(jax.random.split(jkey, n)))


@pytest.mark.parametrize("n", [1, 7, 4097])
def test_random_bits_matches_jax(n):
    key = trandom.split(trandom.prng_key(9), 3)[2]
    jkey = jax.random.split(jax.random.PRNGKey(9), 3)[2]
    np.testing.assert_array_equal(
        _np(trandom.random_bits(key, n)),
        np.asarray(jax.random.bits(jkey, (n,), jnp.uint32), np.uint64))


@pytest.mark.parametrize("q", [1, 2, 1625, 1626, 11314, 804414, 3 * 10 ** 6])
def test_shuffle_rounds_match_jax(q):
    """The rounds of _shuffle: ⌈3 ln q / ln(2³² − 1)⌉."""
    want = int(np.ceil(3 * np.log(max(1, q))
                       / np.log(np.iinfo(np.uint32).max)))
    assert trandom.shuffle_rounds(q) == want
    assert trandom.shuffle_rounds(1625) == 1
    assert trandom.shuffle_rounds(1626) == 2


@pytest.mark.parametrize("q,s", [(1, 1), (10, 3), (1000, 250),
                                 (11314, 2829), (30000, 7500)])
def test_choice_without_replacement_matches_jax(q, s):
    """Index for index, in the reference's order, under the key the
    reference's first sampled term draws with at seed 0."""
    key = trandom.fold_in(trandom.prng_key(0), 0)
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    got = trandom.choice_without_replacement(key, q, s)
    want = np.asarray(jax.random.choice(jkey, q, (s,), replace=False))
    assert got.dtype == torch.int64 and got.shape == (s,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_choice_refuses_a_sample_larger_than_the_population():
    with pytest.raises(ValueError, match="0 < s <= q"):
        trandom.choice_without_replacement(trandom.prng_key(0), 3, 4)


def test_key_stream_schedule_matches_the_reference_fit_loop():
    """Step i of a block from iteration `it` draws under split(fold_in(key,
    it + i), 3), the counter read from its tensor; advance moves it past
    the block. A copy is independent, load takes another's state."""
    ks = trandom.KeyStream.start(trandom.prng_key(5))
    jkey = jax.random.PRNGKey(5)
    for block in range(3):
        for i in range(4):
            want = jax.random.split(jax.random.fold_in(jkey, 4 * block + i),
                                    3)
            np.testing.assert_array_equal(_np(ks.step_keys(i)), _jkey(want))
        ks.advance(4)
    assert int(ks.it) == 12
    c = ks.copy()
    c.advance(1)
    assert int(ks.it) == 12 and int(c.it) == 13
    ks.load(c)
    assert int(ks.it) == 13 and torch.equal(ks.key, c.key)


@pytest.mark.parametrize("n", [1, 7, 4097])
def test_sort_keys_keep_the_bits_order(n):
    """The SORT_KEYS form is the bits minus 2³¹ as int32: a stable sort of
    it orders as a stable sort of the uint32 bits (jax's sort_key_val)."""
    key = trandom.fold_in(trandom.prng_key(2), 5)
    bits = tthreefry.threefry_bits(key, n)
    keys = tthreefry.threefry_bits(key, n, form=tthreefry.SORT_KEYS)
    assert keys.dtype == torch.int32
    np.testing.assert_array_equal(keys.numpy().astype(np.int64) + 2 ** 31,
                                  bits.numpy())
    assert torch.equal(torch.sort(keys, stable=True).indices,
                       torch.sort(bits, stable=True).indices)


def test_cpu_draws_count_no_launch():
    """On the CPU the plain version runs and no kernel launch is counted."""
    before = launch_counts().get("threefry", 0)
    trandom.choice_without_replacement(trandom.prng_key(1), 2000, 10)
    assert launch_counts().get("threefry", 0) == before


def test_threefry_refuses_bad_operands():
    with pytest.raises(ValueError, match="int64 key"):
        tthreefry.threefry_bits(torch.zeros(2, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="int64 key"):
        tthreefry.threefry_bits(torch.zeros(3, dtype=torch.int64), 4)
    with pytest.raises(ValueError, match="counter"):
        tthreefry.threefry_bits(torch.zeros(2, dtype=torch.int64), 4,
                                base=torch.zeros(2, dtype=torch.int64))


@pytest.fixture
def fake_threefry(monkeypatch):
    """threefry_bits' launch code on CPU tensors: a fake library whose
    entry records its arguments and returns ``rc``, and a fake raw stream.
    Yields the record."""
    import types

    from pycmf_tpu_torch.ops.kernels import _build

    rec = types.SimpleNamespace(loads=[], calls=[], rc=0)

    def entry(*args):
        rec.calls.append(args)
        return rec.rc

    def fake_load(name):
        rec.loads.append(name)
        return types.SimpleNamespace(
            pycmf_threefry=entry,
            pycmf_error_string=lambda rc: b"fake failure")

    monkeypatch.setattr(_build, "load", fake_load)
    monkeypatch.setattr(_build, "_functions", {})
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 0xBEEF, raising=False)
    monkeypatch.setattr(tthreefry, "on_card", lambda *t: True)
    yield rec


@pytest.mark.parametrize("form", [tthreefry.BITS, tthreefry.PAIRS,
                                  tthreefry.SORT_KEYS])
@pytest.mark.parametrize("derived", [False, True])
def test_threefry_launch_passes_its_operands(fake_threefry, form, derived):
    """On a card tensor the wrapper launches (no plain fallback): the key's
    and counter's addresses, offset, start, n, the form, the output's
    address, the device and the raw stream; one launch counted; the output
    (n,) int64, (n, 2) int64 or (n,) int32."""
    import ctypes

    from pycmf_tpu_torch.ops.kernels import _build

    key = trandom.prng_key(3)
    base = torch.tensor(5, dtype=torch.int64) if derived else None
    before = launch_counts().get("threefry", 0)
    out = tthreefry.threefry_bits(key, 7, base=base, offset=2, start=11,
                                  form=form)
    assert out.dtype == (torch.int32 if form == tthreefry.SORT_KEYS
                         else torch.int64)
    assert out.shape == ((7, 2) if form == tthreefry.PAIRS else (7,))
    (args,) = fake_threefry.calls
    fn = _build._functions[("threefry", "pycmf_threefry")]
    assert len(args) == len(fn.argtypes) and fn.restype is ctypes.c_int
    assert args[0] == key.data_ptr()
    assert args[1] == (base.data_ptr() if derived else None)
    assert args[2:6] == (2, 11, 7, form)
    assert args[6] == out.data_ptr() and args[-2:] == (-1, 0xBEEF)
    assert fake_threefry.loads == ["threefry"]
    assert launch_counts()["threefry"] == before + 1


def test_threefry_launch_raises_on_a_cuda_error(fake_threefry):
    fake_threefry.rc = 700
    before = launch_counts().get("threefry", 0)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tthreefry.threefry_bits(trandom.prng_key(0), 4)
    with pytest.raises(ValueError, match="at least one"):
        tthreefry.threefry_bits(trandom.prng_key(0), 0)
    with pytest.raises(ValueError, match="SORT_KEYS"):
        tthreefry.threefry_bits(trandom.prng_key(0), 4, form=3)
    assert launch_counts().get("threefry", 0) == before


def test_threefry_source_names_what_it_replaces_and_its_bound():
    from pycmf_tpu_torch.ops.kernels import _build

    head = (_build.CSRC / "threefry.cu").read_text()[:3000]
    assert "Replaces: no Pallas kernel" in head and "Bound:" in head
    assert "pycmf_tpu/solvers/newton.py" in head
    assert "threefry" in _build.NAMES
