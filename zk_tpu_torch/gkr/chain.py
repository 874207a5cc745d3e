"""Device-resident GKR prover chain: one host sync per prove.

Counterpart of ``zk_tpu.gkr.chain``.  The per-phase prover
(``GKRProver.prove`` with ``device_transcript=False``) reads every phase's
round sums back and hashes on the host.  Here the whole per-layer protocol
stays on the device: the sponge state (``transcript.device``), the
sumcheck rounds (a ``sumcheck.record.RoundRecord`` a phase, whose rows
also hold the Montgomery challenges), the eq expansion of the next
phase, W(u) (a fold_multi chain at device challenges), the line
restriction and its q evaluations, the [w_b, w_c] and q_evals
absorption, the r* squeeze, and
the next layer's claim m = q(r*) at r = b* + r* (c* - b*).  The host syncs
are the output-layer fetch (its bytes are proof data and the first
transcript absorb) and one final read of every round polynomial, q_evals
vector and layer claim.

Every absorb and squeeze matches the per-phase prover step for step (bind
m -> phase-1 rounds -> phase-2 rounds -> [w_b, w_c] -> q_evals -> r*), so
the proof is the same bytes as ``GKRProver.prove``'s and ``prove_dense``'s.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.fields.field import Field
from zk_tpu_torch.gkr import device as gdev
from zk_tpu_torch.poly.mle import fold_var0
from zk_tpu_torch.sumcheck.record import RoundRecord
from zk_tpu_torch.transcript import Transcript
from zk_tpu_torch.transcript import device as tdev
from zk_tpu_torch.utils.stat import span, to_host


def _bind(field: Field, pos: int, lo, hi, buf, m_mont):
    """Absorb the canonical BE bytes of one Montgomery (L, 1) element (the
    layer claim m) into the device sponge; returns (lo, hi, buf, pos)."""
    return tdev.absorb(lo, hi, buf, pos, tdev.serialize_canonical(field, dev.from_mont(field, m_mont)))


@functools.lru_cache(maxsize=None)
def _vand_consts(field: Field, k: int, device: torch.device) -> torch.Tensor:
    """(L, k+1, k+1): [:, d, t] = limbs of (t^d R mod p), so mont_mul(c_d,
    V[:, d, t]) = c_d t^d in Montgomery form and the sum over d is q(t):
    the line-restriction evaluations at t = 0..k."""
    L = field.n_limbs
    out = np.zeros((L, k + 1, k + 1), dtype=np.int32)
    for t in range(k + 1):
        for d in range(k + 1):
            v = (pow(t, d, field.p) * field.R) % field.p
            out[:, d, t] = [(v >> (16 * i)) & 0xFFFF for i in range(L)]
    return torch.from_numpy(out).to(device)


def _line_step(field: Field, pos: int, lo, hi, buf, w_dev, u_lk, v_lk):
    """The end-of-layer reduction on the device.  From the sponge at pos,
    the (L, 2^k) lower wire table and the claim points u (= b*), v (= c*)
    as (L, k) Montgomery columns: the line q(t) = W~(u + t (v - u)), its
    evaluations at t = 0..k, absorb [w_b, w_c] ++ q_evals, squeeze r*.
    Returns (lo, hi, buf, canonical (L, k+1) q_evals, the next point
    u + r* (v - u) as (k, L) rows, the next claim q(r*) Montgomery (L, 1))."""
    k = u_lk.shape[1]
    ds_lk = dev.sub_mod(field, v_lk, u_lk)
    coeffs = gdev._line_fold(field, w_dev, u_lk.t(), ds_lk.t())  # (L, k+1)
    evals_m = dev.sum_mod(field, dev.mont_mul(field, coeffs[:, :, None], _vand_consts(field, k, w_dev.device)), axis=1)
    evals_c = dev.from_mont(field, evals_m)  # q(0) = w_b, q(1) = w_c
    data = tdev.serialize_canonical(field, torch.cat([evals_c[:, :2], evals_c], dim=1))
    lo, hi, buf, pos2 = tdev.absorb(lo, hi, buf, pos, data)
    lo, hi, buf, _, digest = tdev.sample_challenge(lo, hi, buf, pos2)
    r_star, _ = tdev.challenge_from_digest(field, digest)
    r_next = dev.add_mod(field, u_lk, dev.mont_mul(field, ds_lk, r_star))
    m_next = coeffs[:, k : k + 1]
    for d in range(k - 1, -1, -1):
        m_next = dev.add_mod(field, dev.mont_mul(field, m_next, r_star), coeffs[:, d : d + 1])
    return lo, hi, buf, evals_c, r_next.t(), m_next


def _run_phase(field: Field, ks, tables, pos: int, lo, hi, buf):
    """All rounds of one phase sumcheck (degree 2) on the device over the
    factor tables of the terms ks, concatenated into one fresh stack, in
    one round record continuing the chain's sponge.  Returns ((n, L, 3)
    canonical round sums, (L, n) Montgomery challenges, lo, hi, buf)."""
    L = field.n_limbs
    stack = torch.cat([t.reshape(1, L, -1) for t in tables])
    n_vars = stack.shape[-1].bit_length() - 1
    record = RoundRecord(field, 2, ks, stack.device, (stack.shape[-1], n_vars, False))
    record.attach(lo, hi, buf, pos)
    record.queue(stack)
    return (record.sums, record.chs_mont[:, :, 0].t().contiguous(), *record.sponge())


def prove_chain(field: Field, circuit, inputs, device=None):
    """Device-resident GKR prove (p > 2^32, every layer with k_in >= 1).
    ``inputs``: host ints (encoded onto ``device``, the card unless named)
    or an (L, n_inputs) Montgomery tensor.  Returns (GKRProof, levels),
    the same proof as GKRProver.prove's per-phase path."""
    from zk_tpu_torch.gkr import GKRProof, LayerProof
    from zk_tpu_torch.sumcheck import SumcheckProof

    nb, L = field.n_bytes, field.n_limbs
    with span("zk.gkr.witness"):
        levels = gdev.evaluate_device(circuit, field, inputs, device)
        d = levels[0].device
        n_out = len(circuit.layers[0])
        out_bytes = dev.decode_bytes_be(field, levels[0])[: n_out * nb]  # a host sync

    transcript = Transcript()
    with span("zk.gkr.bind_outputs"):
        transcript.append(out_bytes)
        r = transcript.sample_n_field_elements(field, circuit.layer_k(0))
        m_mont = gdev.mle_eval_points(field, levels[0], [r])  # (L, 1)
        lo, hi, buf, pos = tdev.state_to_device(*transcript.export_state(), d)
        r_kl = gdev._mont_rs(field, r, d)

    per_layer = []  # (claim m, round sums, canonical q_evals), on the device
    with span("zk.gkr.layer_chain"):
        for i in range(circuit.depth):
            eq_r = gdev._eq_expand(field, r_kl)
            w_dev = levels[i + 1]

            # phase 1 over b: bind m, then G1(b) W(b) + A2(b)
            g1, a2 = gdev.phase1_tables(field, circuit, i, eq_r, w_dev)
            m_layer = m_mont
            lo, hi, buf, pos = _bind(field, pos, lo, hi, buf, m_layer)
            sums1, u_lk, lo, hi, buf = _run_phase(field, (2, 1), [g1, w_dev, a2], pos, lo, hi, buf)

            # phase 2 over c, b fixed at u (the claim is already bound)
            eq_u = gdev._eq_expand(field, u_lk.t())
            wu = fold_var0(field, w_dev, u_lk)
            add_u, mul_u_s, w_shift = gdev.phase2_tables(field, circuit, i, eq_r, eq_u, w_dev, wu)
            sums2, v_lk, lo, hi, buf = _run_phase(field, (2, 2), [add_u, w_shift, mul_u_s, w_dev], 32, lo, hi, buf)

            # line restriction, r*, and the next layer's (r, m)
            lo, hi, buf, q_canon, r_kl, m_mont = _line_step(field, 32, lo, hi, buf, w_dev, u_lk, v_lk)
            pos = 32
            per_layer.append((m_layer, torch.cat([sums1, sums2]), q_canon))
            del g1, a2, add_u, mul_u_s, w_shift, eq_r, eq_u

    with span("zk.gkr.parse_outputs"):  # overlaps the device's drain
        outputs = [int.from_bytes(out_bytes[i * nb : (i + 1) * nb], "big") for i in range(n_out)]

    # the one sync: every proof component
    with span("zk.gkr.final_sync"):
        parts = [t for layer in per_layer for t in layer]
        flat = to_host(torch.cat([t.reshape(-1).long() for t in parts]))
        got = iter(torch.split(flat, [t.numel() for t in parts]))
        layer_proofs = []
        for i in range(circuit.depth):
            m_h, sums_h, q_h = next(got), next(got), next(got)
            k_in = circuit.layer_k(i + 1)
            sums_h = sums_h.reshape(2 * k_in, L, 3)
            q_evals = dev.host_ints(field, q_h.reshape(L, k_in + 1), mont=False)
            layer_proofs.append(LayerProof(
                sumcheck=SumcheckProof(
                    sum=dev.host_ints(field, m_h.reshape(L, 1))[0],
                    round_polys=[dev.host_ints(field, s, mont=False) for s in sums_h],
                ),
                w_b=q_evals[0],
                w_c=q_evals[1],
                q_evals=q_evals,
            ))
    return GKRProof(outputs=outputs, layer_proofs=layer_proofs, outputs_bytes=out_bytes), levels
