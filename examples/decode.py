#!/usr/bin/env python
"""jpg -> png converter CLI, the analog of the reference's example
(`/root/reference/examples/decode.rs:14-84`): prints ImageInfo and metadata
presence, converts CMYK to RGB for viewing, writes a PNG.

Usage: python examples/decode.py input.jpg [output.png] [--backend jax]
       [--precision fast|exact] [--scale WxH] [--streaming]

--streaming decodes from the file handle with bounded buffering (the
reference's `io::Read` contract) instead of loading the input up front.
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from jpeg_decoder_jax import Decoder, PixelFormat


def cmyk_to_rgb(px: np.ndarray) -> np.ndarray:
    f = px.astype(np.float32) / 255.0
    c, m, y, k = f[..., 0], f[..., 1], f[..., 2], f[..., 3]
    c = c * (1 - k) + k
    m = m * (1 - k) + k
    y = y * (1 - k) + k
    return (np.stack([(1 - c), (1 - m), (1 - y)], axis=-1) * 255).astype(np.uint8)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output", nargs="?", default=None)
    ap.add_argument("--backend", default="numpy", choices=["numpy", "jax"])
    ap.add_argument("--precision", default="exact", choices=["exact", "fast"])
    ap.add_argument("--scale", default=None, help="WxH requested size (1/8..1 IDCT scaling)")
    ap.add_argument("--streaming", action="store_true",
                    help="bounded-memory decode straight off the file handle")
    args = ap.parse_args()

    if args.streaming:
        decoder = Decoder(open(args.input, "rb"), backend=args.backend,
                          precision=args.precision, streaming=True)
    else:
        decoder = Decoder(args.input, backend=args.backend,
                          precision=args.precision)
    if args.scale:
        w, h = map(int, args.scale.lower().split("x"))
        print("scaled to:", decoder.scale(w, h))

    pixels = decoder.decode_array()
    info = decoder.info()
    print(f"{info.width}x{info.height} {info.pixel_format.value} "
          f"{info.coding_process.value}")
    print("exif:", decoder.exif_data() is not None,
          " xmp:", decoder.xmp_data() is not None,
          " icc:", decoder.icc_profile() is not None)

    out = args.output or (args.input.rsplit(".", 1)[0] + ".png")
    if info.pixel_format == PixelFormat.CMYK32:
        pixels = cmyk_to_rgb(pixels)
    if info.pixel_format == PixelFormat.L16:
        pixels = (pixels >> 8).astype(np.uint8)  # PNG writers want 8-bit here

    from PIL import Image
    Image.fromarray(pixels).save(out)
    print("wrote", out)


if __name__ == "__main__":
    main()
