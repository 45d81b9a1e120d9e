"""Write the committed JPEG fixtures of ``tests/data/jpeg`` with OpenCV.

    python3 tools/make_jpeg_fixtures.py

Six 640 x 480 frames, the size of REAL275's and of the Wild6D frames the
port's eval reads, one for each case the decoder must cover: 4:2:0,
4:2:2 and 4:4:4 sampling, gray, restart markers and optimized Huffman
tables.  ``digests.json`` holds the sha256 of the array ``cv2.imread``
returns for each (its shape too), which ``tests/test_torch_jpeg.py``
holds against OpenCV and ``chip_smoke.py`` against ``data/jpeg.py``
where there is no OpenCV.  The scene is smooth shapes over gradients
with mild noise, drawn from a seed, so the files stay small.
"""

import hashlib
import json
import os

import cv2
import numpy as np

HERE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "data", "jpeg")

CASES = {
    "420.jpg": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420],
    "422.jpg": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
    "444.jpg": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    "gray.jpg": [],
    "restart.jpg": [cv2.IMWRITE_JPEG_RST_INTERVAL, 7],
    "optimized.jpg": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
}


def scene(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:480, 0:640].astype(np.float64)
    img = np.stack([x / 639 * 200, y / 479 * 180,
                    90 + 60 * np.sin(x / 37.0) * np.cos(y / 29.0)], -1)
    for _ in range(6):
        cx, cy = rng.uniform(60, 580), rng.uniform(60, 420)
        r = rng.uniform(20, 90)
        color = rng.uniform(0, 255, 3)
        inside = (x - cx) ** 2 + (y - cy) ** 2 < r * r
        img[inside] = color
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def digest(img: np.ndarray) -> dict:
    return {"shape": list(img.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes())
            .hexdigest()}


def main() -> None:
    digests = {}
    for i, (name, params) in enumerate(CASES.items()):
        img = scene(i)
        if name == "gray.jpg":
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        path = os.path.join(HERE, name)
        assert cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, 85]
                           + params)
        digests[name] = digest(cv2.imread(path))
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
