"""Rate-1/n convolutional codec (encoder + soft-decision Viterbi decoder).

Shared by Galileo E1B I/NAV (rate 1/2, K=7, polys 171/133 octal with the
second branch inverted per the Galileo OS ICD) and GLONASS L3OC CDMA nav
data. Functional equivalent of the reference's Scilab decoder library
(GALILEO/E1/convolution_decoding/convol_decoder.sci:43-220 and its soft
variant convol_decoder_soft.sci; GLONASS/L3 ships the same library) —
re-implemented as a vectorized add-compare-select over all 2^(K-1) states
per step instead of the reference's per-path window recursion.

Note: the reference decoder uses polynomial order (133, 171) with no
branch inversion (decode_gll_data.sci:34-40); real Galileo signals use
(171, 133) with G2 inverted. Both are expressible here via `polys` /
`invert`; the defaults follow the ICD.

Symbol convention throughout gnsstpu: coded bit b in {0,1} is transmitted
as the BPSK level (1 - 2b), so +1 means 0. Soft inputs are correlator
outputs of arbitrary scale with that sign convention.

Copied from gnsstpu/nav/viterbi.py; only the import prefix differs.
"""

from __future__ import annotations

import numpy as np


def _poly_taps(poly: int, K: int) -> np.ndarray:
    """Tap vector g[0..K-1] (g[0] = current input bit) from an octal-style
    integer whose MSB (bit K-1) multiplies the current input."""
    return np.array([(poly >> (K - 1 - i)) & 1 for i in range(K)], np.int8)


def conv_encode(bits: np.ndarray, polys=(0o171, 0o133),
                invert=(False, True), K: int = 7,
                flush: bool = True) -> np.ndarray:
    """Encode 0/1 bits; returns interleaved symbols [n*(len+tail)] in {0,1}.

    flush=True appends K-1 zero tail bits (the Galileo I/NAV convention:
    114 data + 6 tail -> 240 symbols).
    """
    u = np.asarray(bits, np.int8)
    if flush:
        u = np.concatenate([u, np.zeros(K - 1, np.int8)])
    n = len(polys)
    padded = np.concatenate([np.zeros(K - 1, np.int8), u])
    out = np.zeros((len(u), n), np.int8)
    for j, (p, inv) in enumerate(zip(polys, invert)):
        taps = _poly_taps(p, K)
        acc = np.zeros(len(u), np.int8)
        for i in range(K):
            if taps[i]:
                acc ^= padded[K - 1 - i:len(padded) - i]
        out[:, j] = acc ^ (1 if inv else 0)
    return out.reshape(-1)


def _tables(polys, invert, K):
    """Expected BPSK levels per (state, input): [2^(K-1), 2, n] in ±1.

    State s encodes the previous K-1 inputs with the most recent in the
    top bit: s = u(k-1)·2^(K-2) + ... + u(k-K+1).
    """
    n = len(polys)
    S = 1 << (K - 1)
    s = np.arange(S)
    exp = np.zeros((S, 2, n), np.float32)
    for j, (p, inv) in enumerate(zip(polys, invert)):
        taps = _poly_taps(p, K)
        for b in (0, 1):
            acc = np.full(S, b * taps[0], np.int8)
            for i in range(1, K):
                if taps[i]:
                    # u(k-i) is bit (K-1-i) of s.
                    acc ^= ((s >> (K - 1 - i)) & 1).astype(np.int8)
            if inv:
                acc ^= 1
            exp[:, b, j] = 1.0 - 2.0 * acc
    return exp


def viterbi_decode(soft: np.ndarray, polys=(0o171, 0o133),
                   invert=(False, True), K: int = 7,
                   flushed: bool = True) -> np.ndarray:
    """Maximum-likelihood decode of soft symbols (sign convention +1 = 0).

    soft: [n*L] floats (hard decisions work too: pass ±1).
    flushed=True assumes the encoder appended K-1 zero tail bits; the
    traceback then starts from state 0 and the tail is stripped.
    Returns 0/1 bits, length L - (K-1) if flushed else L.
    """
    n = len(polys)
    r = np.asarray(soft, np.float32).reshape(-1, n)       # [L, n]
    L = r.shape[0]
    S = 1 << (K - 1)
    exp = _tables(polys, invert, K)                        # [S, 2, n]
    half = S >> 1
    # Predecessors of state s': b = s' >> (K-2); preds = 2*(s' mod half) + {0,1}.
    sp = np.arange(S)
    b_of = (sp >> (K - 2)).astype(np.int8)                 # input that led here
    pred = np.stack([(sp & (half - 1)) << 1,
                     ((sp & (half - 1)) << 1) | 1])        # [2, S]
    # Branch levels arranged per destination: exp[pred[i, s'], b_of[s']].
    elev = exp[pred, b_of[None, :], :]                     # [2, S, n]

    pm = np.full(S, -1e30, np.float32)
    pm[0] = 0.0
    choice = np.zeros((L, S), np.int8)
    for k in range(L):
        bm = elev @ r[k]                                   # [2, S]
        cand = pm[pred] + bm
        choice[k] = np.argmax(cand, axis=0)
        pm = np.take_along_axis(cand, choice[k][None, :], 0)[0]

    s = 0 if flushed else int(np.argmax(pm))
    bits = np.zeros(L, np.int8)
    for k in range(L - 1, -1, -1):
        bits[k] = b_of[s]
        s = pred[choice[k, s], s]
    return bits[: L - (K - 1)] if flushed else bits
