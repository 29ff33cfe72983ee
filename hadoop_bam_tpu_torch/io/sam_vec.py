"""Vectorized SAM text parse: a whole split in array passes.

Counterpart of the NumPy tier of ``hadoop_bam_tpu/io/sam_vec.py``: every
line of a split is tokenized at once (newline and tab ``nonzero`` scans,
batched gathers) and emitted as the *binary* record blob, byte for byte
what ``spec.sam.sam_line_to_record(...).encode()`` gives line by line, so
SAM text feeds the same SoA decode, keys and sort as BAM.  The reference's
native C tier is not ported: this tier writes the same bytes alone.

Anything the array passes cannot prove well-formed (short field counts,
non-integer cores, names outside the header, tags the exact encoder would
reject, any non-ASCII byte: the exact parser works on code points) returns
``None`` and the caller takes the exact per-line parser, whose errors are
the contract.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..spec import bam
from .text import gather_padded, line_table, MAX_LINE_LENGTH

# -- lookup tables -----------------------------------------------------------

_SEQ_LUT = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(bam.SEQ_DECODE):
    _SEQ_LUT[ord(_c)] = _i
    _SEQ_LUT[ord(_c.lower())] = _i

_CIGAR_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(bam.CIGAR_OPS):
    _CIGAR_LUT[ord(_c)] = _i
# Ops consuming reference bases (span for reg2bin): M D N = X
_CIGAR_REF = np.zeros(16, dtype=np.int64)
for _i, _c in enumerate(bam.CIGAR_OPS):
    if _c in "MDN=X":
        _CIGAR_REF[_i] = 1

_IS_DIGIT = np.zeros(256, dtype=bool)
_IS_DIGIT[48:58] = True

_INT_FIELDS = (1, 3, 4, 7, 8)  # flag, pos, mapq, pnext, tlen


def _parse_ints(a, starts, lens):
    """Vectorized decimal parse of byte slices.  Returns (vals int64, ok)."""
    n = len(starts)
    if n == 0:
        return np.empty(0, np.int64), True
    W = int(lens.max())
    if W == 0 or W > 11:  # empty field or > int32-class digits
        return None, False
    mat = gather_padded(a, starts, lens, W)
    col = np.arange(W, dtype=np.int64)[None, :]
    valid = col < lens[:, None]
    neg = mat[:, 0] == 0x2D  # '-'
    first_dig = neg.astype(np.int64)
    dig_mask = valid & (col >= first_dig[:, None])
    d = mat.astype(np.int64) - 48
    if (((d < 0) | (d > 9)) & dig_mask).any() or (lens <= first_dig).any():
        return None, False
    vals = np.zeros(n, dtype=np.int64)
    for c in range(W):
        live = dig_mask[:, c]
        vals = np.where(live, vals * 10 + d[:, c], vals)
    return np.where(neg, -vals, vals), True


def _reg2bin_np(beg, end):
    """Vectorized UCSC binning (spec.bam.reg2bin semantics)."""
    e = end - 1
    out = np.zeros(len(beg), dtype=np.int64)
    done = np.zeros(len(beg), dtype=bool)
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (e >> shift))
        out[hit] = offset + (beg[hit] >> shift)
        done |= hit
    return out


def _ragged_copy(dst, dst_off, src_off, lens, a, chunk=1 << 22):
    """dst[dst_off[i]+j] = a[src_off[i]+j] for j < lens[i], chunked so the
    index temporaries stay cache-sized."""
    n = len(lens)
    if n == 0:
        return
    csum = np.concatenate(([0], np.cumsum(lens)))
    r0 = 0
    while r0 < n:
        r1 = int(np.searchsorted(csum, csum[r0] + chunk, side="left"))
        r1 = max(r0 + 1, min(n, r1))
        ln = lens[r0:r1]
        total = int(csum[r1] - csum[r0])
        if total:
            j = np.arange(total, dtype=np.int64) - np.repeat(
                csum[r0:r1] - csum[r0], ln
            )
            dst[np.repeat(dst_off[r0:r1], ln) + j] = a[
                np.repeat(src_off[r0:r1], ln) + j
            ]
        r0 = r1


def _scatter_u32(dst, at, vals):
    v = vals.astype(np.int64)
    for b in range(4):
        dst[at + b] = (v >> (8 * b)) & 0xFF


def _scatter_u16(dst, at, vals):
    v = vals.astype(np.int64)
    dst[at] = v & 0xFF
    dst[at + 1] = (v >> 8) & 0xFF


def _refid_lookup(a, starts, lens, header, allow_eq=False):
    """Vectorized reference-name → index via unique padded rows.

    Returns (refid int32[n], eq_mask, ok).  ``allow_eq`` treats '=' as a
    marker resolved by the caller (RNEXT).  Unknown names — or a hash
    collision between distinct names (verified by comparing every row
    against its bucket representative) — give ok=False and the exact path
    takes over."""
    n = len(starts)
    W = max(1, int(lens.max()) if n else 1)
    if W > 64:
        return None, None, False
    mat = gather_padded(a, starts, lens, W)
    Wp = -(-W // 8) * 8
    packed = np.zeros((n, Wp), np.uint8)
    packed[:, :W] = mat
    words = packed.view(np.uint64).reshape(n, Wp // 8)
    key = lens.astype(np.uint64).copy()
    for w in range(Wp // 8):
        key ^= words[:, w] * np.uint64(0x9E3779B97F4A7C15 + 2 * w + 1)
    uniq, first_idx, inv = np.unique(
        key, return_index=True, return_inverse=True
    )
    # The xor-mix is only a bucketing key: a collision would merge two
    # distinct names into one bucket.  Verify every row equals its bucket
    # representative byte-for-byte; any mismatch → exact path.
    if not (
        (mat == mat[first_idx][inv]).all()
        and (lens == lens[first_idx][inv]).all()
    ):
        return None, None, False
    names = []
    for i in first_idx:
        ln = int(lens[i])
        names.append(bytes(mat[i, :ln]).decode("ascii"))
    ids = np.empty(len(names), np.int64)
    eqs = np.zeros(len(names), bool)
    for k, nm in enumerate(names):
        if allow_eq and nm == "=":
            eqs[k] = True
            ids[k] = 0
            continue
        try:
            ids[k] = header.ref_index(nm)
        except KeyError:
            return None, None, False
    return ids[inv], eqs[inv], True


def _parse_cigars(a, starts, lens):
    """All CIGAR fields → (n_ops[n], op_values concat, span[n], ok).

    ``op_values`` are the BAM encoding ``len<<4 | op`` in record order;
    ``span`` sums reference-consuming op lengths (for reg2bin)."""
    n = len(starts)
    n_ops = np.zeros(n, dtype=np.int64)
    span = np.zeros(n, dtype=np.int64)
    star = (lens == 1) & (a[starts] == 0x2A)  # '*'
    act = ~star & (lens > 0)
    if (lens == 0).any():
        return None, None, None, False
    if not act.any():
        return n_ops, np.empty(0, np.int64), span, True
    # Concatenate the active cigar fields.
    c_lens = lens[act]
    M = int(c_lens.sum())
    concat = np.empty(M, dtype=np.uint8)
    csum = np.concatenate(([0], np.cumsum(c_lens)))
    _ragged_copy(concat, csum[:-1], starts[act], c_lens, a)
    rid = np.repeat(np.arange(len(c_lens)), c_lens)  # active-row id per char
    is_op = _CIGAR_LUT[concat] != 255
    is_dig = _IS_DIGIT[concat]
    if not (is_op | is_dig).all():
        return None, None, None, False
    # Last char of each field must be an op; field must start with a digit.
    if not is_op[csum[1:] - 1].all() or not is_dig[csum[:-1]].all():
        return None, None, None, False
    # A digit must follow every op except at field end.
    after_op = np.zeros(M, dtype=bool)
    after_op[1:] = is_op[:-1]
    after_op[csum[:-1]] = False  # field starts belong to this field
    if (after_op & ~is_dig).any():
        return None, None, None, False
    op_pos = np.nonzero(is_op)[0]
    G = len(op_pos)
    # Digit group = index of the op it precedes.
    grp = np.cumsum(is_op) - is_op
    dig_pos = np.nonzero(is_dig)[0]
    dgrp = grp[dig_pos]
    counts = np.bincount(dgrp, minlength=G)
    if (counts > 9).any():  # > 9 digits: let the exact path range-check
        return None, None, None, False
    gstart = np.concatenate(([0], np.cumsum(counts)))[:-1]
    idx_in_grp = np.arange(len(dig_pos)) - gstart[dgrp]
    weight = 10 ** (counts[dgrp] - 1 - idx_in_grp).astype(np.int64)
    vals = np.bincount(
        dgrp, weights=(concat[dig_pos] - 48).astype(np.int64) * weight,
        minlength=G,
    ).astype(np.int64)
    if (vals >= (1 << 28)).any():
        return None, None, None, False
    opc = _CIGAR_LUT[concat[op_pos]].astype(np.int64)
    op_rid = rid[op_pos]
    n_ops_act = np.bincount(op_rid, minlength=len(c_lens))
    n_ops[act] = n_ops_act
    span_act = np.bincount(
        op_rid, weights=vals * _CIGAR_REF[opc], minlength=len(c_lens)
    ).astype(np.int64)
    span[act] = span_act
    return n_ops, (vals << 4) | opc, span, True


_TAG_I_WIDTH_BOUNDS = (
    (1, -128, 127),        # c
    (1, 0, 255),           # C
    (2, -32768, 32767),    # s
    (2, 0, 65535),         # S
    (4, -(1 << 31), (1 << 31) - 1),  # i
    (4, 0, (1 << 32) - 1),  # I
)
_TAG_I_CODES = b"cCsSiI"


def _encode_tags(a, tok_start, tok_len, tok_rid, n_records):
    """Vectorized tag tokens → (tag_bytes_per_record, blob).

    Tokens are ``TAG:T:VALUE`` byte slices in row-major (record, position)
    order — exactly ``f[11:]`` order, already filtered to len >= 5 (the
    exact parser skips shorter tokens).  A/i/Z/H are vectorized, f/B (and
    unknown types, which must raise through the exact encoder) encode one
    token at a time.  Returns None on anything the exact path should error
    on."""
    from ..spec.sam import _encode_tag

    T = len(tok_start)
    if T == 0:
        return np.zeros(n_records, np.int64), np.empty(0, np.uint8)
    typ = a[tok_start + 3]
    vstart = tok_start + 5
    vlen = tok_len - 5
    is_A = typ == ord("A")
    is_i = typ == ord("i")
    is_Z = (typ == ord("Z")) | (typ == ord("H"))
    is_other = ~(is_A | is_i | is_Z)

    enc_len = np.zeros(T, dtype=np.int64)
    enc_len[is_A] = 3 + np.minimum(vlen[is_A], 1)
    enc_len[is_Z] = 3 + vlen[is_Z] + 1

    ivals = None
    iwidth = None
    icode = None
    if is_i.any():
        ivals, ok = _parse_ints(a, vstart[is_i], vlen[is_i])
        if not ok:
            return None
        iwidth = np.zeros(len(ivals), dtype=np.int64)
        icode = np.zeros(len(ivals), dtype=np.uint8)
        done = np.zeros(len(ivals), dtype=bool)
        for k, (w, lo, hi) in enumerate(_TAG_I_WIDTH_BOUNDS):
            hit = ~done & (ivals >= lo) & (ivals <= hi)
            iwidth[hit] = w
            icode[hit] = _TAG_I_CODES[k]
            done |= hit
        if not done.all():
            return None  # out of u32 range: exact path raises SamError
        enc_len[is_i] = 3 + iwidth

    other_blobs = {}
    if is_other.any():
        # f/B (and any unknown type, which must raise via the exact
        # encoder): per-token host encode — rare types.
        oi = np.nonzero(is_other)[0]
        for t in oi:
            s, l = int(tok_start[t]), int(tok_len[t])
            tok = bytes(a[s : s + l]).decode("ascii")
            try:
                b = _encode_tag(tok[:2], tok[3], tok[5:])
            except Exception:
                return None
            other_blobs[int(t)] = np.frombuffer(b, np.uint8)
            enc_len[t] = len(b)

    dst = np.concatenate(([0], np.cumsum(enc_len)))[:-1]
    blob = np.zeros(int(enc_len.sum()), dtype=np.uint8)
    blob[dst] = a[tok_start]
    blob[dst + 1] = a[tok_start + 1]
    blob[dst + 2] = typ
    if is_A.any():
        has_v = is_A & (vlen > 0)
        blob[dst[has_v] + 3] = a[vstart[has_v]]
    if is_Z.any():
        _ragged_copy(blob, dst[is_Z] + 3, vstart[is_Z], vlen[is_Z], a)
        # NUL already zero-initialized.
    if ivals is not None and len(ivals):
        iv = ivals.astype(np.int64) & 0xFFFFFFFF  # two's complement
        d_i = dst[is_i]
        for b in range(4):
            m = iwidth > b
            blob[d_i[m] + 3 + b] = (iv[m] >> (8 * b)) & 0xFF
        blob[d_i + 2] = icode
    for t, ob in other_blobs.items():
        blob[dst[t] : dst[t] + len(ob)] = ob
    rec_bytes = np.bincount(
        tok_rid, weights=enc_len, minlength=n_records
    ).astype(np.int64)
    return rec_bytes, blob


# -- the tokenizer -------------------------------------------------------------
#
# It produces the column table ``sc``:
#   name_src/name_len (len 0 for '*'), rname_src/len, cigar_src/len,
#   rnext_src/len, seq_src/len, qual_src/len — int64[n]
#   int_src/int_len — int64[n, 5]: flag, pos1, mapq, pnext1, tlen
#   tok_start/tok_len/tok_rid — tag tokens, row-major, len >= 5 only


def _scan_numpy(a, lo: int, end: int) -> Optional[dict]:
    starts, lens = line_table(a, lo, end)
    if len(starts):
        keep = (lens > 0) & (a[np.minimum(starts, len(a) - 1)] != 0x40)
        starts, lens = starts[keep], lens[keep]
    n = len(starts)
    if n == 0:
        return {k: np.empty(0, np.int64) for k in (
            "name_src", "name_len", "rname_src", "rname_len", "cigar_src",
            "cigar_len", "rnext_src", "rnext_len", "seq_src", "seq_len",
            "qual_src", "qual_len", "tok_start", "tok_len", "tok_rid",
            "int_src", "int_len",
        )}
    line_end = starts + lens
    window_end = min(len(a), end + 4 * (MAX_LINE_LENGTH + 1))
    if window_end < len(a) and bool((line_end >= window_end).any()):
        return None  # line cut off by the bounded scan window

    # Field table: the k-th tab of line i.
    wlo, whi = int(starts[0]), int(line_end.max())
    tabs = wlo + np.nonzero(a[wlo:whi] == 0x09)[0]
    if len(tabs) == 0:
        return None
    t0 = np.searchsorted(tabs, starts)
    tk = t0[:, None] + np.arange(10)
    exists = tk < len(tabs)
    Tt = tabs[np.minimum(tk, len(tabs) - 1)]
    if not (exists & (Tt < line_end[:, None])).all():
        return None  # < 11 fields: exact error text needed
    fstart = np.concatenate([starts[:, None], Tt + 1], axis=1)  # [n, 11]
    tk10 = t0 + 10
    has_tags = (tk10 < len(tabs)) & (
        tabs[np.minimum(tk10, len(tabs) - 1)] < line_end
    )
    f10_end = np.where(
        has_tags, tabs[np.minimum(tk10, len(tabs) - 1)], line_end
    )
    fend = np.concatenate([Tt, f10_end[:, None]], axis=1)
    flen = fend - fstart

    qn_len = flen[:, 0].copy()
    qn_len[(qn_len == 1) & (a[fstart[:, 0]] == 0x2A)] = 0

    sc = {
        "name_src": fstart[:, 0], "name_len": qn_len,
        "rname_src": fstart[:, 2], "rname_len": flen[:, 2],
        "cigar_src": fstart[:, 5], "cigar_len": flen[:, 5],
        "rnext_src": fstart[:, 6], "rnext_len": flen[:, 6],
        "seq_src": fstart[:, 9], "seq_len": flen[:, 9],
        "qual_src": fstart[:, 10], "qual_len": flen[:, 10],
        "int_src": fstart[:, _INT_FIELDS],
        "int_len": flen[:, _INT_FIELDS],
    }

    # Tag tokens, row-major.
    tok_s_l, tok_e_l, tok_r_l = [], [], []
    if has_tags.any():
        t_hi = np.searchsorted(tabs, line_end)
        extra = t_hi - (t0 + 10)  # tag-separating tabs per line
        for k in range(int(extra.max())):
            live = has_tags & (extra >= k + 1)
            if not live.any():
                break
            ti = t0[live] + 10 + k
            s = tabs[ti] + 1
            nxt = ti + 1
            e = np.where(
                (nxt < len(tabs))
                & (tabs[np.minimum(nxt, len(tabs) - 1)] < line_end[live]),
                tabs[np.minimum(nxt, len(tabs) - 1)],
                line_end[live],
            )
            tok_s_l.append(s)
            tok_e_l.append(e)
            tok_r_l.append(np.nonzero(live)[0])
    if tok_s_l:
        tok_s = np.concatenate(tok_s_l)
        tok_e = np.concatenate(tok_e_l)
        tok_r = np.concatenate(tok_r_l)
        order = np.lexsort((tok_s, tok_r))
        tok_s, tok_e, tok_r = tok_s[order], tok_e[order], tok_r[order]
        keep = (tok_e - tok_s) >= 5
        sc["tok_start"] = tok_s[keep]
        sc["tok_len"] = (tok_e - tok_s)[keep]
        sc["tok_rid"] = tok_r[keep]
    else:
        sc["tok_start"] = np.empty(0, np.int64)
        sc["tok_len"] = np.empty(0, np.int64)
        sc["tok_rid"] = np.empty(0, np.int64)
    return sc


# -- the finisher -----------------------------------------------------


def _finish(a, sc: dict, header) -> Optional[np.ndarray]:
    """Column table → binary record blob."""
    n = len(sc["name_src"])
    if n == 0:
        return np.empty(0, np.uint8)
    parsed = []
    for c in range(5):
        vals, ok = _parse_ints(a, sc["int_src"][:, c], sc["int_len"][:, c])
        if not ok:
            return None
        parsed.append(vals)
    flag, pos1, mapq, pnext1, tlen = parsed
    if (
        (flag < 0).any() or (flag > 0xFFFF).any()
        or (mapq < 0).any() or (mapq > 0xFF).any()
        or (np.abs(tlen) >= (1 << 31)).any()
        or (pos1 < 0).any() or (pnext1 < 0).any()
        or (pos1 > (1 << 31)).any() or (pnext1 > (1 << 31)).any()
    ):
        return None  # the exact path's struct.pack raises the real error

    refid, _, ok = _refid_lookup(a, sc["rname_src"], sc["rname_len"], header)
    if not ok:
        return None
    nrefid, eq_mask, ok = _refid_lookup(
        a, sc["rnext_src"], sc["rnext_len"], header, allow_eq=True
    )
    if not ok:
        return None
    nrefid = np.where(eq_mask, refid, nrefid)

    n_ops, op_vals, span, ok = _parse_cigars(
        a, sc["cigar_src"], sc["cigar_len"]
    )
    if not ok:
        return None
    if (n_ops > 0xFFFF).any():
        return None  # n_cigar_op overflows u16: exact path raises

    qn_len = sc["name_len"]
    if (qn_len + 1 > 255).any():
        return None  # exact path raises BamError("read name too long")
    seq_len = sc["seq_len"]
    seq_star = (seq_len == 1) & (a[sc["seq_src"]] == 0x2A)
    l_seq = np.where(seq_star, 0, seq_len)
    seq_bytes = (l_seq + 1) // 2
    qual_len = sc["qual_len"]
    # '*' OR empty: build_record's `qual if qual else 0xFF*l_seq` treats an
    # empty (zero-length) QUAL field exactly like '*'.
    qual_star = (
        (qual_len == 1) & (a[sc["qual_src"]] == 0x2A)
    ) | (qual_len == 0)
    qual_bytes = np.where(qual_star, l_seq, qual_len)

    res = _encode_tags(a, sc["tok_start"], sc["tok_len"], sc["tok_rid"], n)
    if res is None:
        return None
    tag_rec_bytes, tag_blob = res

    body_len = (
        32 + qn_len + 1 + 4 * n_ops + seq_bytes + qual_bytes + tag_rec_bytes
    )
    off = np.concatenate(([0], np.cumsum(body_len + 4)))
    total = int(off[-1])
    rec = off[:-1]
    pos0 = pos1 - 1
    npos0 = pnext1 - 1
    # bin: unmapped flag → span 1; else max(1, cigar span); pos<0 → 4680.
    eff_span = np.where((flag & bam.FLAG_UNMAPPED) != 0, 1,
                        np.maximum(1, span))
    bin_ = np.where(pos0 >= 0, _reg2bin_np(pos0, pos0 + eff_span), 4680)
    if (bin_ > 0xFFFF).any():
        return None  # bin overflows u16 (> ~1 Gbp positions): exact raises
    op_off = np.concatenate(([0], np.cumsum(n_ops)))[:-1]
    tag_at_rec = np.concatenate(([0], np.cumsum(tag_rec_bytes)))[:-1]

    # -- emit -----------------------------------------------------------
    out = np.zeros(total, dtype=np.uint8)
    body = rec + 4
    _scatter_u32(out, rec, body_len)
    _scatter_u32(out, body + 0, refid & 0xFFFFFFFF)
    _scatter_u32(out, body + 4, pos0 & 0xFFFFFFFF)
    out[body + 8] = (qn_len + 1) & 0xFF
    out[body + 9] = mapq & 0xFF
    _scatter_u16(out, body + 10, bin_)
    _scatter_u16(out, body + 12, n_ops)
    _scatter_u16(out, body + 14, flag)
    _scatter_u32(out, body + 16, l_seq)
    _scatter_u32(out, body + 20, nrefid & 0xFFFFFFFF)
    _scatter_u32(out, body + 24, npos0 & 0xFFFFFFFF)
    _scatter_u32(out, body + 28, tlen & 0xFFFFFFFF)

    name_at = body + 32
    _ragged_copy(out, name_at, sc["name_src"], qn_len, a)
    cig_at = name_at + qn_len + 1
    if len(op_vals):
        op_rid = np.repeat(np.arange(n), n_ops)
        op_k = np.arange(len(op_vals)) - np.repeat(op_off, n_ops)
        _scatter_u32(out, cig_at[op_rid] + 4 * op_k, op_vals)
    seq_at = cig_at + 4 * n_ops
    act = ~seq_star & (l_seq > 0)
    if act.any():
        sb = seq_bytes[act]
        ssum = np.concatenate(([0], np.cumsum(sb)))
        tot = int(ssum[-1])
        j = np.arange(tot, dtype=np.int64) - np.repeat(ssum[:-1], sb)
        src0 = np.repeat(sc["seq_src"][act], sb) + 2 * j
        ls_r = np.repeat(l_seq[act], sb)
        hi_nib = _SEQ_LUT[a[src0]].astype(np.uint8)
        has_lo = 2 * j + 1 < ls_r
        lo_nib = np.where(
            has_lo, _SEQ_LUT[a[np.minimum(src0 + 1, len(a) - 1)]], 0
        ).astype(np.uint8)
        out[np.repeat(seq_at[act], sb) + j] = (hi_nib << 4) | lo_nib
    qual_at = seq_at + seq_bytes
    qs = qual_star & (l_seq > 0)
    if qs.any():
        # 0xFF fill for '*' quals (vectorized run fill)
        ln = l_seq[qs]
        csum = np.concatenate(([0], np.cumsum(ln)))
        j = np.arange(int(csum[-1]), dtype=np.int64) - np.repeat(
            csum[:-1], ln
        )
        out[np.repeat(qual_at[qs], ln) + j] = 0xFF
    qv = ~qual_star
    if qv.any():
        ln = qual_len[qv]
        csum = np.concatenate(([0], np.cumsum(ln)))
        tot = int(csum[-1])
        if tot:
            j = np.arange(tot, dtype=np.int64) - np.repeat(csum[:-1], ln)
            src = np.repeat(sc["qual_src"][qv], ln) + j
            vals = a[src].astype(np.int16) - 33
            if (vals < 0).any():
                return None
            out[np.repeat(qual_at[qv], ln) + j] = vals.astype(np.uint8)
    if len(tag_blob):
        tag_at = qual_at + qual_bytes
        ln = tag_rec_bytes
        csum = np.concatenate(([0], np.cumsum(ln)))
        j = np.arange(int(csum[-1]), dtype=np.int64) - np.repeat(
            csum[:-1], ln
        )
        out[np.repeat(tag_at, ln) + j] = tag_blob
    return out


def parse_split_vectorized(
    data, start: int, end: int, header
) -> Optional[np.ndarray]:
    """Parse every SAM line starting in ``[start, end)`` into the binary
    record blob (uint8 array), or ``None`` when any line needs the exact
    per-line parser.  Byte-identical to concatenating
    ``sam_line_to_record(line).encode()`` over the same lines."""
    a = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
    lo = start
    window_end = min(len(a), end + 4 * (MAX_LINE_LENGTH + 1))
    if lo > 0:
        # Split resync (SplitLineReader semantics), searched inside the
        # bounded window only — a resync point beyond it means a giant
        # line, which the exact path handles.
        w = np.flatnonzero(a[lo - 1 : window_end] == 0x0A)
        if len(w) == 0:
            return np.empty(0, np.uint8) if window_end == len(a) else None
        lo = lo - 1 + int(w[0]) + 1
        if lo >= end:
            return np.empty(0, np.uint8)
    # The exact parser operates on decoded code points; byte-level
    # equivalence holds only for pure-ASCII content (a non-ASCII SEQ
    # changes l_seq, invalid UTF-8 must raise).  One cheap screen over the
    # scan window sends anything non-ASCII to the exact path.
    if len(a) and bool((a[lo:window_end] >= 0x80).any()):
        return None
    sc = _scan_numpy(a, lo, end)
    if sc is None:
        return None
    return _finish(a, sc, header)
