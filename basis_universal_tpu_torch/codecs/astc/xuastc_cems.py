"""Copy of `basis_universal_tpu/codecs/astc/xuastc_cems.py`.

LDR CEM endpoint decode / requantize / cross-CEM conversion.

Integer-exact ports of the XUASTC LDR spec helpers (deterministic, no
floats — the reference stresses this for cross-platform bit-exactness):
  - astc_helpers::decode_endpoint           (basisu_astc_helpers.h:2172)
  - bit_transfer_signed_{dec,enc}           (basisu_astc_helpers.h:5076)
  - used_blue_contraction                   (basisu_astc_helpers.h:5151)
  - apply_delta_to_bise_endpoint_val        (basisu_astc_helpers.h:5182)
  - requantize_ise_endpoints                (basisu_transcoder.cpp:25473)
  - blue_contract_enc / pack_base_offset    (basisu_transcoder.cpp:25431,:25731)
  - convert_endpoints_across_cems           (basisu_transcoder.cpp:25894)
"""

from . import xuastc_tables as XT

_clamp = lambda v, lo, hi: lo if v < lo else (hi if v > hi else v)


def bit_transfer_signed_dec(a: int, b: int):
    b = (b >> 1) | (a & 0x80)
    a = (a >> 1) & 0x3F
    if a & 0x20:
        a -= 0x40
    return a, b


def bit_transfer_signed_enc(a: int, b: int):
    bit = (b & 0x80) != 0
    b = (b << 1) & 0xFF
    a = (a & 0x3F) << 1
    if bit:
        a |= 0x80
    return a, b


def _blue_contract(r, g, b, a):
    return ((r + b) >> 1, (g + b) >> 1, b, a)


def decode_endpoint_ise20(cem: int, e):
    """e: dequantized [0,255] CEM values. Returns (l, h) RGBA tuples."""
    v0, v1 = e[0], e[1]
    if cem == XT.CEM_LDR_LUM_DIRECT:
        return (v0, v0, v0, 255), (v1, v1, v1, 255)
    if cem == XT.CEM_LDR_LUM_BASE_PLUS_OFS:
        l0 = (v0 >> 2) | (v1 & 0xC0)
        l1 = min(l0 + (v1 & 0x3F), 255)
        return (l0, l0, l0, 255), (l1, l1, l1, 255)
    if cem == XT.CEM_LDR_LUM_ALPHA_DIRECT:
        v2, v3 = e[2], e[3]
        return (v0, v0, v0, v2), (v1, v1, v1, v3)
    if cem == XT.CEM_LDR_LUM_ALPHA_BASE_PLUS_OFS:
        v2, v3 = e[2], e[3]
        d0, b0 = bit_transfer_signed_dec(v1, v0)
        d1, b1 = bit_transfer_signed_dec(v3, v2)
        lo = _clamp(b0, 0, 255)
        hi = _clamp(b0 + d0, 0, 255)
        la = _clamp(b1, 0, 255)
        ha = _clamp(b1 + d1, 0, 255)
        return (lo, lo, lo, la), (hi, hi, hi, ha)
    if cem == XT.CEM_LDR_RGB_BASE_SCALE:
        v2, v3 = e[2], e[3]
        return ((v0 * v3) >> 8, (v1 * v3) >> 8, (v2 * v3) >> 8, 255), \
            (v0, v1, v2, 255)
    if cem == XT.CEM_LDR_RGB_DIRECT:
        v2, v3, v4, v5 = e[2], e[3], e[4], e[5]
        if v1 + v3 + v5 >= v0 + v2 + v4:
            return (v0, v2, v4, 255), (v1, v3, v5, 255)
        return _blue_contract(v1, v3, v5, 255), _blue_contract(v0, v2, v4, 255)
    if cem == XT.CEM_LDR_RGB_BASE_PLUS_OFFSET:
        v2, v3, v4, v5 = e[2], e[3], e[4], e[5]
        d0, b0 = bit_transfer_signed_dec(v1, v0)
        d1, b1 = bit_transfer_signed_dec(v3, v2)
        d2, b2 = bit_transfer_signed_dec(v5, v4)
        if d0 + d1 + d2 >= 0:
            lo = (b0, b1, b2, 255)
            hi = (b0 + d0, b1 + d1, b2 + d2, 255)
        else:
            lo = _blue_contract(b0 + d0, b1 + d1, b2 + d2, 255)
            hi = _blue_contract(b0, b1, b2, 255)
        return tuple(_clamp(v, 0, 255) for v in lo), \
            tuple(_clamp(v, 0, 255) for v in hi)
    if cem == XT.CEM_LDR_RGB_BASE_SCALE_PLUS_TWO_A:
        v2, v3, v4, v5 = e[2], e[3], e[4], e[5]
        return ((v0 * v3) >> 8, (v1 * v3) >> 8, (v2 * v3) >> 8, v4), \
            (v0, v1, v2, v5)
    if cem == XT.CEM_LDR_RGBA_DIRECT:
        v2, v3, v4, v5, v6, v7 = e[2], e[3], e[4], e[5], e[6], e[7]
        if v1 + v3 + v5 >= v0 + v2 + v4:
            return (v0, v2, v4, v6), (v1, v3, v5, v7)
        return _blue_contract(v1, v3, v5, v7), _blue_contract(v0, v2, v4, v6)
    if cem == XT.CEM_LDR_RGBA_BASE_PLUS_OFFSET:
        v2, v3, v4, v5, v6, v7 = e[2], e[3], e[4], e[5], e[6], e[7]
        d0, b0 = bit_transfer_signed_dec(v1, v0)
        d1, b1 = bit_transfer_signed_dec(v3, v2)
        d2, b2 = bit_transfer_signed_dec(v5, v4)
        d3, b3 = bit_transfer_signed_dec(v7, v6)
        if d0 + d1 + d2 >= 0:
            lo = (b0, b1, b2, b3)
            hi = (b0 + d0, b1 + d1, b2 + d2, b3 + d3)
        else:
            lo = _blue_contract(b0 + d0, b1 + d1, b2 + d2, b3 + d3)
            hi = _blue_contract(b0, b1, b2, b3)
        return tuple(_clamp(v, 0, 255) for v in lo), \
            tuple(_clamp(v, 0, 255) for v in hi)
    raise ValueError(f"non-LDR CEM {cem}")


def decode_endpoints(cem: int, endpoints, ise_range: int):
    """ISE-encoded endpoints → ((l RGBA), (h RGBA)) in [0,255]."""
    tab = XT.endpoint_tab(ise_range).ise_to_val
    deq = [int(tab[v]) for v in endpoints[:XT.cem_num_values(cem)]]
    return decode_endpoint_ise20(cem, deq)


def used_blue_contraction(cem: int, endpoints, ise_range: int) -> bool:
    if cem in (8, 12):
        tab = XT.endpoint_tab(ise_range).ise_to_val
        d = [int(tab[endpoints[i]]) for i in range(6)]
        return (d[1] + d[3] + d[5]) < (d[0] + d[2] + d[4])
    if cem in (9, 13):
        tab = XT.endpoint_tab(ise_range).ise_to_val
        d = [int(tab[endpoints[i]]) for i in range(6)]
        d1, _ = bit_transfer_signed_dec(d[1], d[0])
        d3, _ = bit_transfer_signed_dec(d[3], d[2])
        d5, _ = bit_transfer_signed_dec(d[5], d[4])
        return (d1 + d3 + d5) < 0
    return False


def apply_delta_to_bise_endpoint_val(ise_range: int, ise_val: int,
                                     delta: int) -> int:
    if delta == 0:
        return ise_val
    tab = XT.endpoint_tab(ise_range)
    n = tab.ise_to_rank.shape[0]
    new_rank = _clamp(int(tab.ise_to_rank[ise_val]) + delta, 0, n - 1)
    return int(tab.rank_to_ise[new_rank])


def blue_contract_enc(rgba, did_clamp: list, encoded_b: int):
    r, g, b, a = rgba
    tr = r * 2 - encoded_b
    tg = g * 2 - encoded_b
    if tr < 0 or tr > 255 or tg < 0 or tg > 255:
        did_clamp[0] = True
    return (_clamp(tr, 0, 255), _clamp(tg, 0, 255), b, a)


def requantize_ise_endpoints(cem: int, src_range: int, src, dst_range: int):
    """Returns the requantized endpoint list (len = cem value count)."""
    n = XT.cem_num_values(cem)
    src = [int(v) for v in src[:n]]
    if src_range == dst_range:
        return list(src)
    if src_range != 20:
        tab = XT.endpoint_tab(src_range).ise_to_val
        deq = [int(tab[v]) for v in src]
    else:
        deq = list(src)
    if dst_range == 20:
        return deq
    dst_tab = XT.endpoint_tab(dst_range)
    q = dst_tab.val_to_ise
    dq = dst_tab.ise_to_val

    if cem in (9, 13):
        p2 = XT.quantize_preserve2(dst_range)
        dst = [int(p2[deq[i]]) if (i & 1) else int(q[deq[i]])
               for i in range(n)]
        src_bc = used_blue_contraction(cem, src, src_range)

        def deltas_sum(vals):
            d1, _ = bit_transfer_signed_dec(int(dq[vals[1]]), int(dq[vals[0]]))
            d3, _ = bit_transfer_signed_dec(int(dq[vals[3]]), int(dq[vals[2]]))
            d5, _ = bit_transfer_signed_dec(int(dq[vals[5]]), int(dq[vals[4]]))
            return d1 + d3 + d5

        quant_bc = deltas_sum(dst) < 0
        if src_bc != quant_bc:
            pos, neg = XT.base_ofs_nudges(dst_range)
            nudge = pos if quant_bc else neg
            cur_c_rover = 2
            for _ in range(5):
                for j in range(3):
                    i = (cur_c_rover + j) % 3
                    new_v = int(nudge[dst[1 + i * 2]])
                    if new_v != dst[1 + i * 2]:
                        dst[1 + i * 2] = new_v
                        break
                quant_bc = deltas_sum(dst) < 0
                if src_bc == quant_bc:
                    break
                cur_c_rover += 1
        return dst

    if cem in (8, 12):
        s0 = deq[0] + deq[2] + deq[4]
        s1 = deq[1] + deq[3] + deq[5]
        orig_bc = s1 < s0
        dst = [int(q[v]) for v in deq]
        qs0 = int(dq[dst[0]]) + int(dq[dst[2]]) + int(dq[dst[4]])
        qs1 = int(dq[dst[1]]) + int(dq[dst[3]]) + int(dq[dst[5]])
        quant_bc = qs1 < qs0
        if orig_bc != quant_bc:
            if qs0 == qs1:
                if qs1:
                    for i in range(3):
                        nv = apply_delta_to_bise_endpoint_val(
                            dst_range, dst[1 + i * 2], -1)
                        if nv != dst[1 + i * 2]:
                            dst[1 + i * 2] = nv
                            break
                else:
                    for i in range(3):
                        nv = apply_delta_to_bise_endpoint_val(
                            dst_range, dst[i * 2], 1)
                        if nv != dst[i * 2]:
                            dst[i * 2] = nv
                            break
            else:
                for i in range(0, 6, 2):
                    dst[i], dst[i + 1] = dst[i + 1], dst[i]
                if cem == 12:
                    dst[6], dst[7] = dst[7], dst[6]
        return dst

    return [int(q[v]) for v in deq]


def pack_base_offset(cem: int, dst_range: int, l, h,
                     use_bc: bool, auto_disable_bc: bool):
    """Returns (endpoints, bc_clamped, base_ofs_clamped, swapped)."""
    bc_clamped = [False]
    base_ofs_clamped = False
    swapped = False
    pack_l, pack_h = tuple(l), tuple(h)

    if use_bc:
        enc_l = blue_contract_enc(pack_l, bc_clamped, pack_l[2])
        enc_h = blue_contract_enc(pack_h, bc_clamped, pack_h[2])
        if bc_clamped[0] and auto_disable_bc:
            use_bc = False
        else:
            pack_h, pack_l = enc_l, enc_h
            swapped = True

    dr = dg = db = da = 0
    low_clamp = -32
    for p in range(4):
        odr = pack_h[0] - pack_l[0]
        odg = pack_h[1] - pack_l[1]
        odb = pack_h[2] - pack_l[2]
        oda = pack_h[3] - pack_l[3]
        base_ofs_clamped = False
        dr = _clamp(odr, low_clamp, 31)
        if dr != odr:
            base_ofs_clamped = True
        dg = _clamp(odg, low_clamp, 31)
        if dg != odg:
            base_ofs_clamped = True
        db = _clamp(odb, low_clamp, 31)
        if db != odb:
            base_ofs_clamped = True
        da = _clamp(oda, low_clamp, 31)
        if da != oda:
            base_ofs_clamped = True
        s = dr + dg + db
        pack_uses_bc = s < 0
        if pack_uses_bc == use_bc:
            break
        if s == 0:
            if db > -32:
                db -= 1
            elif dr > -32:
                dr -= 1
            elif dg > -32:
                dg -= 1
            break
        if p == 3:
            break
        if p == 1:
            low_clamp = -31
        pack_l, pack_h = pack_h, pack_l
        swapped = not swapped

    v1, v0 = bit_transfer_signed_enc(dr, pack_l[0])
    v3, v2 = bit_transfer_signed_enc(dg, pack_l[1])
    v5, v4 = bit_transfer_signed_enc(db, pack_l[2])
    new8 = [v0, v1, v2, v3, v4, v5]
    if cem in XT.CEMS_WITH_ALPHA:
        v7, v6 = bit_transfer_signed_enc(da, pack_l[3])
        new8 += [v6, v7]
    out = requantize_ise_endpoints(cem, 20, new8, dst_range)
    return out, bc_clamped[0], base_ofs_clamped, swapped


def convert_endpoints_across_cems(prev_cem: int, prev_range: int, prev_vals,
                                  dst_cem: int, dst_range: int,
                                  always_repack: bool, use_bc: bool,
                                  auto_disable_bc: bool):
    """Returns (endpoints, bc_clamped, base_ofs_clamped)."""
    dst_tab = XT.endpoint_tab(dst_range)
    q = dst_tab.val_to_ise
    dq = dst_tab.ise_to_val
    n_dst = XT.cem_num_values(dst_cem)

    if prev_cem == dst_cem and not always_repack:
        return (requantize_ise_endpoints(prev_cem, prev_range, prev_vals,
                                         dst_range), False, False)

    if not always_repack:
        prev_base = XT.get_base_cem_without_alpha(prev_cem)
        dst_base = XT.get_base_cem_without_alpha(dst_cem)
        dst_has_a = dst_cem in XT.CEMS_WITH_ALPHA
        if prev_base == dst_base and not dst_has_a:
            return (requantize_ise_endpoints(prev_base, prev_range, prev_vals,
                                             dst_range), False, False)
        if prev_base == dst_base and dst_has_a:
            out = requantize_ise_endpoints(prev_base, prev_range, prev_vals,
                                           dst_range)
            ise_a = int(q[255])
            out = out + [0] * (n_dst - len(out))
            if dst_cem == XT.CEM_LDR_LUM_ALPHA_DIRECT:
                out[2] = out[3] = ise_a
            elif dst_cem == XT.CEM_LDR_RGBA_DIRECT:
                out[6] = out[7] = ise_a
            elif dst_cem == XT.CEM_LDR_RGB_BASE_SCALE_PLUS_TWO_A:
                out[4] = out[5] = ise_a
            elif dst_cem == XT.CEM_LDR_RGBA_BASE_PLUS_OFFSET:
                out[6] = ise_a
                out[7] = int(q[128])
            else:
                raise ValueError(dst_cem)
            return out, False, False

    prev_l, prev_h = decode_endpoints(prev_cem, prev_vals, prev_range)
    bc_clamped = [False]

    if dst_cem in (XT.CEM_LDR_LUM_DIRECT, XT.CEM_LDR_LUM_ALPHA_DIRECT):
        new8 = [0] * n_dst
        new8[0] = (prev_l[0] + prev_l[1] + prev_l[2] + 1) // 3
        new8[1] = (prev_h[0] + prev_h[1] + prev_h[2] + 1) // 3
        if dst_cem == XT.CEM_LDR_LUM_ALPHA_DIRECT:
            new8[2] = prev_l[3]
            new8[3] = prev_h[3]
        if prev_cem not in (XT.CEM_LDR_LUM_DIRECT, XT.CEM_LDR_LUM_ALPHA_DIRECT):
            if new8[0] > new8[1]:
                new8[0], new8[1] = new8[1], new8[0]
                if dst_cem == XT.CEM_LDR_LUM_ALPHA_DIRECT:
                    new8[2], new8[3] = new8[3], new8[2]
        return (requantize_ise_endpoints(dst_cem, 20, new8, dst_range),
                False, False)

    if dst_cem in (XT.CEM_LDR_RGB_DIRECT, XT.CEM_LDR_RGBA_DIRECT):
        new8 = [prev_l[0], prev_h[0], prev_l[1], prev_h[1],
                prev_l[2], prev_h[2]]
        if dst_cem == XT.CEM_LDR_RGBA_DIRECT:
            new8 += [prev_l[3], prev_h[3]]
        if use_bc:
            enc_l = blue_contract_enc(
                prev_l, bc_clamped, int(dq[q[prev_l[2]]]))
            enc_h = blue_contract_enc(
                prev_h, bc_clamped, int(dq[q[prev_h[2]]]))
            if auto_disable_bc and bc_clamped[0]:
                use_bc = False
            else:
                new8[0], new8[1] = enc_h[0], enc_l[0]
                new8[2], new8[3] = enc_h[1], enc_l[1]
                new8[4], new8[5] = enc_h[2], enc_l[2]
                if dst_cem == XT.CEM_LDR_RGBA_DIRECT:
                    new8[6], new8[7] = prev_h[3], prev_l[3]
        s0 = new8[0] + new8[2] + new8[4]
        s1 = new8[1] + new8[3] + new8[5]
        pack_bc = s1 < s0
        if pack_bc != use_bc:
            if s0 == s1:
                if s1:
                    for i in range(3):
                        nv = apply_delta_to_bise_endpoint_val(
                            20, new8[1 + i * 2], -1)
                        if nv != new8[1 + i * 2]:
                            new8[1 + i * 2] = nv
                            break
                else:
                    for i in range(3):
                        nv = apply_delta_to_bise_endpoint_val(
                            20, new8[i * 2], 1)
                        if nv != new8[i * 2]:
                            new8[i * 2] = nv
                            break
            else:
                for i in range(0, n_dst, 2):
                    new8[i], new8[i + 1] = new8[i + 1], new8[i]
        return (requantize_ise_endpoints(dst_cem, 20, new8, dst_range),
                bc_clamped[0], False)

    if dst_cem in (XT.CEM_LDR_RGB_BASE_SCALE,
                   XT.CEM_LDR_RGB_BASE_SCALE_PLUS_TWO_A):
        lc, hc = list(prev_l), list(prev_h)
        if prev_cem not in (XT.CEM_LDR_RGB_BASE_SCALE,
                            XT.CEM_LDR_RGB_BASE_SCALE_PLUS_TWO_A):
            if (lc[0] + lc[1] + lc[2]) > (hc[0] + hc[1] + hc[2]):
                lc, hc = hc, lc
        new8 = [hc[0], hc[1], hc[2], 0]
        idot = lc[0] * hc[0] + lc[1] * hc[1] + lc[2] * hc[2]
        inrm = hc[0] * hc[0] + hc[1] * hc[1] + hc[2] * hc[2]
        imax_s = (1024 * 255) // 256
        iscale = imax_s
        if inrm > 0:
            iscale = (idot * 1024) // inrm
        iscale = _clamp(iscale, 0, imax_s)
        iscale = _clamp((iscale + 2) >> 2, 0, 255)
        new8[3] = iscale
        if dst_cem == XT.CEM_LDR_RGB_BASE_SCALE_PLUS_TWO_A:
            new8 += [lc[3], hc[3]]
            if prev_cem not in (XT.CEM_LDR_RGB_BASE_SCALE,
                                XT.CEM_LDR_RGB_BASE_SCALE_PLUS_TWO_A):
                if new8[4] > new8[5]:
                    new8[4], new8[5] = new8[5], new8[4]
        return (requantize_ise_endpoints(dst_cem, 20, new8, dst_range),
                False, False)

    if dst_cem in (XT.CEM_LDR_RGB_BASE_PLUS_OFFSET,
                   XT.CEM_LDR_RGBA_BASE_PLUS_OFFSET):
        out, bc_c, bo_c, _sw = pack_base_offset(
            dst_cem, dst_range, prev_l, prev_h, use_bc, auto_disable_bc)
        return out, bc_c, bo_c

    raise ValueError(f"unsupported dst CEM {dst_cem}")
