"""The port's device sponge against zk_tpu's host Transcript and device
sponge, byte for byte (tolerance 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zk_tpu.transcript import Transcript
from zk_tpu.transcript import device as jt
from zk_tpu.transcript.keccak import Keccak256, keccak256, keccak_f1600
from zk_tpu_torch import interop
from zk_tpu_torch.fields import BLS12_377_FR, BLS12_381_FR, GOLDILOCKS
from zk_tpu_torch.fields import device as tdev
from zk_tpu_torch.sumcheck import kernels as K
from zk_tpu_torch.transcript import Transcript as TTranscript
from zk_tpu_torch.transcript import device as tt

torch.set_num_threads(1)


def _state(lanes):
    lo = torch.tensor([l & 0xFFFFFFFF for l in lanes], dtype=torch.int64)
    hi = torch.tensor([l >> 32 for l in lanes], dtype=torch.int64)
    return lo, hi


def _lanes(lo, hi):
    return [a | (b << 32) for a, b in zip(lo.tolist(), hi.tolist())]


def _fresh():
    z = torch.zeros(25, dtype=torch.int64)
    return z, z, torch.zeros(tt.RATE, dtype=torch.int64), 0


def test_keccak_plain_matches_xla_and_host():
    rng = np.random.default_rng(5)
    states = [[int(x) for x in rng.integers(0, 1 << 63, size=25, dtype=np.uint64)] for _ in range(4)]
    lo = torch.stack([_state(s)[0] for s in states])
    hi = torch.stack([_state(s)[1] for s in states])
    glo, ghi = tt.keccak_f1600_device(lo, hi)  # CPU tensors: the plain version
    for i, s in enumerate(states):
        assert _lanes(glo[i], ghi[i]) == keccak_f1600(list(s))
    xlo, xhi = jt._keccak_f1600_xla(jnp.asarray(lo[0].numpy().astype(np.uint32)), jnp.asarray(hi[0].numpy().astype(np.uint32)))
    np.testing.assert_array_equal(glo[0].numpy(), np.asarray(xlo).astype(np.int64))
    np.testing.assert_array_equal(ghi[0].numpy(), np.asarray(xhi).astype(np.int64))


def test_empty_digest_known_answer():
    digest = tt.squeeze(*_fresh())
    assert bytes(digest.tolist()) == bytes.fromhex(
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    )
    assert bytes(digest.tolist()) == keccak256(b"")


@pytest.mark.parametrize("sizes", [(1, 31, 32), (135, 1, 136), (137, 272, 300), (0, 135)])
def test_absorb_squeeze_matches_host(sizes):
    rng = np.random.default_rng(sum(sizes))
    host = Keccak256()
    lo, hi, buf, pos = _fresh()
    for n in sizes:
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        host.update(data)
        lo, hi, buf, pos = tt.absorb(lo, hi, buf, pos, torch.tensor(list(data), dtype=torch.int64))
        assert bytes(tt.squeeze(lo, hi, buf, pos).tolist()) == host.digest()


@pytest.mark.parametrize("field", [GOLDILOCKS, BLS12_381_FR, BLS12_377_FR], ids=lambda f: f.name)
def test_challenges_through_exported_state(field):
    """A host transcript hands its sponge to the port mid-stream (export),
    both sample the same challenges, and the state comes back (import)."""
    host, mirror = Transcript(), Transcript()
    for t in (host, mirror):
        t.append(b"prefix bytes of some length" * 7)
    lo, hi, buf, pos = tt.state_to_device(*host.export_state(), "cpu")
    for step in range(3):
        data = bytes(range(step * 40, step * 40 + 64))
        mirror.append(data)
        want = int.from_bytes(mirror.sample_challenge(), "big") % field.p
        lo, hi, buf, pos = tt.absorb(lo, hi, buf, pos, torch.tensor(list(data)))
        lo, hi, buf, pos, digest = tt.sample_challenge(lo, hi, buf, pos)
        mont, canon = tt.challenge_from_digest(field, digest)
        assert tdev.decode_ints(field, canon, mont=False) == [want]
        assert tdev.decode_ints(field, mont) == [want]
    host.import_state(*tt.state_to_host(lo, hi, buf, pos))
    assert host.sample_challenge() == mirror.sample_challenge()


def test_state_matches_jax_state_to_device():
    host = Transcript()
    host.append(b"x" * 150)
    lanes, pend = host.export_state()
    jlo, jhi, jbuf, jpos = jt.state_to_device(lanes, pend)
    lo, hi, buf, pos = interop.transcript_state_from_jax(jlo, jhi, jbuf, jpos, "cpu")
    tlo, thi, tbuf, tpos = tt.state_to_device(lanes, pend, "cpu")
    assert torch.equal(lo, tlo) and torch.equal(hi, thi) and torch.equal(buf, tbuf) and pos == tpos
    back = interop.transcript_state_to_jax(tlo, thi, tbuf, tpos)
    for a, b in zip(back[:3], (jlo, jhi, jbuf)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("field", [GOLDILOCKS, BLS12_381_FR], ids=lambda f: f.name)
def test_serialize_canonical_matches_host_bytes(field):
    vals = [0, 1, field.p - 1, 0xDEADBEEF % field.p, (field.p * 2) // 3]
    t = tdev.encode_ints(field, vals, device="cpu", mont=False)
    assert bytes(tt.serialize_canonical(field, t).tolist()) == field.elements_to_bytes(vals)


@pytest.mark.parametrize("field", [GOLDILOCKS, BLS12_381_FR], ids=lambda f: f.name)
def test_transcript_round_matches_host_round(field):
    """One Fiat-Shamir round on the port's sponge equals the host's:
    the canonical sums, their bytes and the challenge."""
    rng = np.random.default_rng(8)
    partials = torch.from_numpy(rng.integers(0, 1 << 30, size=(2, field.n_limbs, 3), dtype=np.int64))
    sums = K.decode_sums(field, partials)
    host = Transcript()
    host.append(field.to_bytes_be(123))
    lo, hi, buf, pos = tt.state_to_device(*host.export_state(), "cpu")
    host.append(field.elements_to_bytes(sums))
    want = int.from_bytes(host.sample_challenge(), "big") % field.p
    lo, hi, buf, total, canon, mont = K.transcript_round(field, pos, lo, hi, buf, partials)
    assert tdev.decode_ints(field, total, mont=False) == sums
    assert tdev.decode_ints(field, canon, mont=False) == [want]
    assert tdev.decode_ints(field, mont) == [want]


def _round_case(field, D, pos, G, seed):
    """A host transcript with pos pending bytes, random (D+1, L, G)
    partials whose column sums stay below 2^56, and the host's own round:
    (state, partials, canonical sums, challenge, host state after)."""
    rng = np.random.default_rng(seed)
    host = TTranscript()
    host.append(rng.integers(0, 256, size=tt.RATE + pos, dtype=np.uint8).tobytes())  # lanes not zero
    state = tt.state_to_device(*host.export_state(), "cpu")
    assert state[3] == pos
    partials = torch.from_numpy(rng.integers(0, 1 << 40, size=(D + 1, field.n_limbs, G), dtype=np.int64))
    sums = K.decode_sums(field, partials)
    host.append(field.elements_to_bytes(sums))
    challenge = host.sample_field_element(field)
    return state, partials, sums, challenge, host.export_state()


# pos 100 with D = 3 crosses a block boundary at BLS12-381 (100 + 128 > 136);
# pos 135 = RATE - 1 pads with the single byte 0x81 when nothing follows
@pytest.mark.parametrize("pos", [0, 32, 100, 135])
@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("field", [GOLDILOCKS, BLS12_381_FR], ids=lambda f: f.name)
def test_transcript_round_plain_matches_host_transcript(field, D, pos):
    """transcript_round_plain (the CPU route of transcript_round, the
    kernel's plain version) against the port's host Transcript: the round
    sums, the challenge in both forms and the sponge it leaves, for D = 1..3,
    pos in {0, 32, 100, 135} and G in {1, 7, 1024} (host ints only)."""
    G = (1, 7, 1024)[(D + pos) % 3]
    (lo, hi, buf, _), partials, sums, challenge, after = _round_case(field, D, pos, G, 8 * D + pos)
    plain = K.transcript_round_plain(field, pos, lo.clone(), hi.clone(), buf.clone(), partials.clone())
    wrapped = K.transcript_round(field, pos, lo, hi, buf, partials)  # its CPU route is the plain version
    assert all(torch.equal(a, b) for a, b in zip(plain, wrapped))
    lo, hi, buf, total, canon, mont = plain
    assert tuple(total.shape) == (field.n_limbs, D + 1) and total.dtype == torch.int32
    assert tdev.decode_ints(field, total, mont=False) == sums
    assert bytes(tt.serialize_canonical(field, total).tolist()) == field.elements_to_bytes(sums)
    assert tdev.decode_ints(field, canon, mont=False) == [challenge]
    assert tdev.decode_ints(field, mont) == [challenge]
    assert tt.state_to_host(lo, hi, buf, 32) == after


def test_transcript_round_plain_pads_a_lone_byte_at_rate_minus_one():
    """Data that leaves exactly RATE - 1 bytes pending: Goldilocks D = 1 is
    16 bytes, so pos = 119 ends at 135 and the digest block's last byte is
    0x01 | 0x80."""
    (lo, hi, buf, pos), partials, sums, challenge, after = _round_case(GOLDILOCKS, 1, 119, 7, 3)
    lo, hi, buf, total, canon, mont = K.transcript_round_plain(GOLDILOCKS, pos, lo, hi, buf, partials)
    assert tdev.decode_ints(GOLDILOCKS, total, mont=False) == sums
    assert tdev.decode_ints(GOLDILOCKS, canon, mont=False) == [challenge]
    assert tt.state_to_host(lo, hi, buf, 32) == after


@pytest.mark.cuda
@pytest.mark.parametrize("field", [GOLDILOCKS, BLS12_381_FR], ids=lambda f: f.name)
def test_cuda_transcript_round_matches_plain(field):
    """On a card: the transcript_round kernel equals its plain version,
    every output tensor, across D, pos and G."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for D, pos, G in ((1, 32, 1024), (2, 0, 7), (3, 100, 1), (1, 135, 3)):
        (lo, hi, buf, _), partials, *_ = _round_case(field, D, pos, G, D + pos)
        args = [t.cuda() for t in (lo, hi, buf, partials)]
        want = K.transcript_round_plain(field, pos, *args)
        got = K.transcript_round(field, pos, *args)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype and torch.equal(w, g)


@pytest.mark.parametrize("sizes", [(0,), (1, 135), (136, 137, 500), (1 << 16,)])
def test_host_keccak_c_and_python_match_jax(sizes):
    """The port's host hashers (C and pure Python) against zk_tpu's."""
    from zk_tpu_torch import transcript as ttr
    from zk_tpu_torch.transcript import keccak as tk
    from zk_tpu_torch.transcript import native

    assert ttr.HAS_NATIVE  # the C hasher builds wherever `cc` is on PATH
    rng = np.random.default_rng(sum(sizes) + 1)
    c_hasher, py_hasher, want = native.NativeKeccak256(native.load()), tk.Keccak256(), Keccak256()
    for n in sizes:
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        for h in (c_hasher, py_hasher, want):
            h.update(data)
    assert c_hasher.export_state() == py_hasher.export_state() == want.export_state()
    c_hasher.import_state(*want.export_state())
    assert c_hasher.finalize_reset() == py_hasher.finalize_reset() == want.finalize_reset()


def test_host_transcript_matches_jax_transcript():
    from zk_tpu_torch.transcript import Transcript as TTranscript

    port, ref = TTranscript(), Transcript()
    for t in (port, ref):
        t.append(b"outputs" * 50)
    assert [port.sample_challenge() for _ in range(3)] == [ref.sample_challenge() for _ in range(3)]
    assert port.sample_n_field_elements(GOLDILOCKS, 2) == [
        int.from_bytes(ref.sample_challenge(), "big") % GOLDILOCKS.p for _ in range(2)
    ]
