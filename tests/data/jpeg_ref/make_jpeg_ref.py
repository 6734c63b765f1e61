"""Write the JPEG decode reference that ``chip_smoke.py`` holds nvJPEG to.

Three 512^2 grayscale planes: two microscopy-like ones
(``rxtpu.data.synthetic.cells_image``) and one of uniform random bytes, as
in the port's synthetic fixture. Each is encoded at quality 95 by rxtpu's
``encode_batch_jpeg`` into ``{i}.jpeg``, and ``planes.npz`` holds what
rxtpu's ``decode_batch`` (libjpeg, JDCT_ISLOW) gives for those files.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/jpeg_ref/make_jpeg_ref.py
"""

import os

import numpy as np

from rxtpu.data.decode import decode_batch, encode_batch_jpeg
from rxtpu.data.synthetic import cells_image

HERE = os.path.dirname(os.path.abspath(__file__))
SIZE = 512


def main() -> None:
    rng = np.random.default_rng(11)
    planes = np.stack([cells_image(rng, SIZE, 5, 1), cells_image(rng, SIZE, 17, 4),
                       rng.integers(0, 256, (SIZE, SIZE), dtype=np.uint8)])
    bufs = encode_batch_jpeg(planes, quality=95)
    for i, buf in enumerate(bufs):
        with open(os.path.join(HERE, f"{i}.jpeg"), "wb") as f:
            f.write(buf)
    decoded = decode_batch(bufs, SIZE, SIZE, strict=True)
    np.savez_compressed(os.path.join(HERE, "planes.npz"), planes=decoded)
    print([len(b) for b in bufs], decoded.shape)


if __name__ == "__main__":
    main()
