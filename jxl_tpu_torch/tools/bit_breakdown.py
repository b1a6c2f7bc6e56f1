"""Where do the bits go? Per-section rate breakdown of a JXT encode (port
of `tools/bit_breakdown.py`).

Reproduces the encoder's token stream (`codec.analysis.
encode_tokens_for_analysis`), its stepped histogram, k-means clustered
(`cluster_histograms_kmeans`) and 12-bit quantized
(`quantize_histograms_t`) tables, and charges every token its rANS cost
log2(M / f[ctx, tok]) under its step's context plus its mantissa bytes,
aggregated by stream section (ACS map, quant field, CfL, nnz and DC per
channel, AC per channel x band), plus the padding tokens and the
container's header / freq-table / states overhead. The sum reconciles
against the container (rANS coding loss against the ideal is < 0.1%), so
the table is the file.

Usage: python -m jxl_tpu_torch.tools.bit_breakdown [image.png] [-d 1.0] [-e 7] [--jpeg] [--device cuda:0]
--jpeg adds a PIL JPEG bpp / PSNR ladder as an anchor.
"""

import numpy as np

from jxl_tpu_torch.tools import CORPUS_DIR, parse, parser


def sections(lay) -> list:
    """[(name, start, end)] of the token stream's sections, in order."""
    from jxl_tpu_torch.codec.layout import N_BANDS, ac_band_table

    nb, n_cfl = lay["nb"], lay["n_cfl"]
    secs = []
    o = 0
    for name, n in (("acs_map", nb), ("quant_field", nb), ("cfl", n_cfl)):
        secs.append((name, o, o + n))
        o += n
    for kind in ("nnz", "dc"):
        for nm in "XYB":
            secs.append((f"{kind}_{nm}", o, o + nb))
            o += nb
    band = ac_band_table()
    for nm in "XYB":
        for b in range(N_BANDS):
            n = int(np.sum(band == b)) * nb
            secs.append((f"ac_{nm}_b{b}", o, o + n))
            o += n
    if o != lay["n_tokens"]:
        raise AssertionError(f"sections cover {o} tokens, the layout {lay['n_tokens']}")
    return secs


def breakdown(rgb: np.ndarray, distance: float, effort: int, dev) -> dict:
    """The rate of each section of rgb's encode on `dev`: {"rows": [(name,
    tok_bits, mant_bits, ntok, nonzero)], "pad_bits", "data" (the
    container), "header_bytes", "words_bytes", "mant_bytes"}."""
    import torch

    from jxl_tpu_torch.codec.analysis import encode_tokens_for_analysis
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import read_container
    from jxl_tpu_torch.codec.encode import (
        K_CLUSTERS,
        _histogram_stepped,
        _step_ctx_v8,
        encode_image,
        encoder_knobs,
        pick_lanes,
    )
    from jxl_tpu_torch.codec.layout import padded_layout, token_layout
    from jxl_tpu_torch.entropy.cluster import cluster_histograms_kmeans
    from jxl_tpu_torch.entropy.rans import RANS_L, RANS_M, quantize_histograms_t

    h, w = rgb.shape[:2]
    lay = token_layout(h, w)
    token, nbits, _mant, _params, q_sorted = encode_tokens_for_analysis(
        rgb, distance, height=h, width=w, effort=effort, device=dev
    )

    # charge every token its coded cost under its STEP's context (nnz-
    # conditioned for the AC phase, boundary-step mismatch included), with
    # the encoder's own tables
    lanes = pick_lanes(lay["n_tokens"], 256)
    play = padded_layout(h, w, lanes)
    step_ctx = _step_ctx_v8(play, q_sorted)
    ctx_padded = np.repeat(step_ctx.cpu().numpy(), lanes)
    tokp = torch.zeros(play["n_padded"], dtype=torch.int32, device=token.device)
    tok_ctx = np.empty(lay["n_tokens"], np.int64)
    src = 0
    for _c, dst, n_real, _n_pad in play["spans"]:
        tokp[dst : dst + n_real] = token[src : src + n_real]
        tok_ctx[src : src + n_real] = ctx_padded[dst : dst + n_real]
        src += n_real
    counts = _histogram_stepped(tokp, step_ctx, lanes, play["n_ctx"])
    cmap, ctables = cluster_histograms_kmeans(counts, k=K_CLUSTERS, greedy=not encoder_knobs().no_greedy)
    freq_k, _ = quantize_histograms_t(ctables)
    freq = freq_k[cmap].cpu().numpy().astype(np.float64)
    bits_tab = np.log2(RANS_M / np.maximum(freq, 1.0))  # [C, A]

    token = token.cpu().numpy()
    nbits = nbits.cpu().numpy()
    tok_bits = bits_tab[tok_ctx, token]
    mant_bits = 8.0 * ((nbits + 7) // 8)
    rows = []
    for name, s, e in sections(lay):
        rows.append((name, float(tok_bits[s:e].sum()), float(mant_bits[s:e].sum()), e - s, int((token[s:e] != 0).sum())))
    # padding tokens: zeros coded in their step's context
    pad_bits = 0.0
    for _c, dst, n_real, n_pad in play["spans"]:
        pad_bits += float(bits_tab[ctx_padded[dst + n_real : dst + n_pad], 0].sum())

    data = encode_image(rgb, CodecConfig(distance=distance, effort=effort), device=dev)
    stream = read_container(data)
    words_b, mant_b = len(stream.stream_words), len(stream.mant_bytes)
    return {
        "rows": rows, "pad_bits": pad_bits, "data": data,
        "header_bytes": len(data) - words_b - mant_b, "words_bytes": words_b, "mant_bytes": mant_b,
        "state_bits": float(np.log2(stream.states.astype(np.float64) / RANS_L).sum()),
    }


def payload_bits(res: dict) -> tuple:
    """(the sections' bits, padding included; the container's payload bits:
    rANS words and mantissa bytes, plus the information the final lane
    states carry, log2(state / L) each). rANS codes at the ideal cost of
    its own tables, so the two agree up to float rounding."""
    sec = sum(tb + mb for _n, tb, mb, _t, _z in res["rows"]) + res["pad_bits"]
    return sec, 8.0 * (res["words_bytes"] + res["mant_bytes"]) + res["state_bits"]


def print_breakdown(res: dict, h: int, w: int, distance: float, effort: int) -> None:
    n_px = h * w
    total_bytes = len(res["data"])
    hdr_b, pad_bits = res["header_bytes"], res["pad_bits"]
    print(f"image {w}x{h}  d={distance} e={effort}  total {total_bytes} B = {total_bytes * 8 / n_px:.4f} bpp")
    print(f"  header+tables+states: {hdr_b} B ({hdr_b * 8 / n_px:.4f} bpp)")
    print(f"  rANS words: {res['words_bytes']} B   mantissa: {res['mant_bytes']} B")
    print(f"  padding tokens: {pad_bits / 8:.0f} B ({pad_bits / n_px:.4f} bpp)")
    print()
    print(f"{'section':<14}{'tok_bits':>12}{'mant_bits':>11}{'bpp':>9}{'ntok':>9}{'nonzero':>9}{'b/tok':>8}")
    tot_tb = tot_mb = 0.0
    for name, tb, mb, n, nz in res["rows"]:
        tot_tb += tb
        tot_mb += mb
        print(f"{name:<14}{tb:>12.0f}{mb:>11.0f}{(tb + mb) / n_px:>9.4f}{n:>9}{nz:>9}{tb / max(n, 1):>8.3f}")
    print(f"{'SUM':<14}{tot_tb:>12.0f}{tot_mb:>11.0f}{(tot_tb + tot_mb) / n_px:>9.4f}")
    ideal = (tot_tb + tot_mb + pad_bits) / 8 + hdr_b
    print(f"ideal total {ideal:.0f} B vs actual {total_bytes} B "
          f"(coding loss {(total_bytes - ideal) / total_bytes * 100:.2f}%)")
    sec, pay = payload_bits(res)
    print(f"sections {sec / 8:.1f} B vs payload {pay / 8:.1f} B (words + mantissa + lane-state information, "
          f"{res['state_bits'] / 8:.1f} B)")


def jpeg_anchor(rgb, target_psnr):
    """PIL JPEG bpp at (approximately) the same PSNR."""
    import io

    from PIL import Image

    im = Image.fromarray(rgb)
    n_px = rgb.shape[0] * rgb.shape[1]
    print("\nJPEG anchor (PIL):")
    for q in (70, 80, 85, 90, 92, 95):
        buf = io.BytesIO()
        im.save(buf, "JPEG", quality=q)
        dec = np.asarray(Image.open(buf)).astype(np.float64)
        mse = ((dec - rgb.astype(np.float64)) ** 2).mean()
        psnr = 10 * np.log10(255.0**2 / mse)
        print(f"  q={q}: {buf.tell() * 8 / n_px:.4f} bpp  {psnr:.2f} dB")


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("image", nargs="?", default=str(CORPUS_DIR / "synth00.png"))
    ap.add_argument("-d", type=float, default=1.0)
    ap.add_argument("-e", type=int, default=7)
    ap.add_argument("--jpeg", action="store_true")
    args = parse(ap, argv)

    from jxl_tpu_torch.codec.decode import decode_bytes
    from jxl_tpu_torch.core.io import read_image

    rgb = read_image(args.image)
    res = breakdown(rgb, args.d, args.e, args.dev)
    print_breakdown(res, *rgb.shape[:2], args.d, args.e)
    dec = decode_bytes(res["data"], device=args.dev)
    mse = ((dec.astype(np.float64) - rgb.astype(np.float64)) ** 2).mean()
    psnr = 10 * np.log10(255.0**2 / mse)
    print(f"decode PSNR {psnr:.2f} dB")
    if args.jpeg:
        jpeg_anchor(rgb, psnr)
    return res


if __name__ == "__main__":
    main()
