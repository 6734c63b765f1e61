"""rxtpu_torch's JPEG input against rxtpu's, on the CPU.

- the port's libjpeg encoder and decoders (``rxtpu_torch/data/decode.py``,
  ``csrc/jpeg_host.cpp``) against rxtpu's native ones, byte for byte and bit
  for bit; strict and zero-fill semantics; the header size probe;
- the ``ByteStore`` pipeline, preloaded and streaming, in train, val and test
  modes, against rxtpu's ``Pipeline`` on rxtpu's synthetic JPEG tree;
- the stats pass and ``run_stats`` against rxtpu's;
- the JPEG tree writer, whose decoded tree equals its pack's planes through
  the pipeline (``chip_smoke.py``'s JPEG phase at a tiny size);
- the nvJPEG reference under ``tests/data/jpeg_ref`` equals the port's
  libjpeg decode; on a card (``gpu``-marked), nvJPEG within one level of it
  and the stats pass on the card equal to the CPU's.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import pytest
import torch

import rxtpu.cli as rx_cli
from rxtpu.config import Config, DataConfig
from rxtpu.data.decode import decode_batch as rx_decode_batch
from rxtpu.data.decode import decode_files as rx_decode_files
from rxtpu.data.decode import encode_batch_jpeg as rx_encode_batch_jpeg
from rxtpu.data.pipeline import ByteStore as RxByteStore
from rxtpu.data.pipeline import Pipeline as RxPipeline
from rxtpu.data.records import load_metadata as rx_load_metadata
from rxtpu.data.records import read_metadata_csvs as rx_read_metadata_csvs
from rxtpu.data.stats import compute_stats_streaming as rx_compute_stats_streaming
from rxtpu.data.synthetic import cells_image
from rxtpu.tools import run_stats as rx_run_stats
from rxtpu_torch import cli as port_cli
from rxtpu_torch import tools as port_tools
from rxtpu_torch.data.decode import decode_batch, decode_files, encode_batch_jpeg, jpeg_size
from rxtpu_torch.data.pack import PackStore, write_raw_pack
from rxtpu_torch.data.pipeline import ByteStore, Pipeline
from rxtpu_torch.data.records import all_records, image_path, load_metadata, read_metadata_csvs
from rxtpu_torch.data.stats import compute_stats_numpy, compute_stats_streaming
from rxtpu_torch.data.synthetic import make_train_fixture, write_jpeg_tree

SRC = 64
REF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg_ref")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run as fast on one intra-op thread, and the suite runs
    test files in parallel workers that would otherwise contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(n=6, seed=0):
    """Microscopy-like planes and one of uniform random bytes."""
    rng = np.random.default_rng(seed)
    cells = [cells_image(rng, SRC, 3 + i, 1 + i % 6) for i in range(n - 1)]
    return np.stack(cells + [rng.integers(0, 256, (SRC, SRC), dtype=np.uint8)])


def _stats(experiments, seed=0):
    rng = np.random.default_rng(seed)
    return {e: {"mean": rng.uniform(0.2, 0.6, 6), "std": rng.uniform(0.1, 0.3, 6)}
            for e in experiments}


def test_encoder_bytes_equal_rxtpu():
    planes = _planes()
    want = rx_encode_batch_jpeg(planes, quality=95)
    for nthreads in (1, 3):
        assert encode_batch_jpeg(planes, 95, nthreads=nthreads) == want
    assert encode_batch_jpeg(torch.from_numpy(planes), 80) == rx_encode_batch_jpeg(planes, 80)


def test_decoders_bit_equal_to_rxtpu(synthetic_root, tmp_path):
    bufs = rx_encode_batch_jpeg(_planes(), quality=95)
    for nthreads in (1, 4):
        got = decode_batch(bufs, SRC, SRC, nthreads=nthreads)
        assert got.dtype == np.uint8 and got.shape == (len(bufs), SRC, SRC)
        np.testing.assert_array_equal(got, rx_decode_batch(bufs, SRC, SRC))
    paths = []
    for i, b in enumerate(bufs):
        paths.append(str(tmp_path / f"p{i}_s1_w1.jpeg"))
        with open(paths[-1], "wb") as f:
            f.write(b)
    np.testing.assert_array_equal(decode_files(paths, SRC, SRC, nthreads=2),
                                  rx_decode_files(paths, SRC, SRC))
    # rxtpu's synthetic tree: cv2's encoder, every file of the train split
    root, _ = synthetic_root
    tree = sorted(glob.glob(os.path.join(root, "train", "*", "*", "*.jpeg")))
    assert len(tree) > 100
    want = rx_decode_files(tree, SRC, SRC, strict=True)
    np.testing.assert_array_equal(decode_files(tree, SRC, SRC, strict=True), want)
    tree_bufs = [open(p, "rb").read() for p in tree]
    np.testing.assert_array_equal(decode_batch(tree_bufs, SRC, SRC, strict=True), want)
    assert len(decode_batch([], SRC, SRC)) == 0 and len(decode_files([], SRC, SRC)) == 0


def test_strict_raises_and_loose_zero_fills(tmp_path):
    bufs = rx_encode_batch_jpeg(_planes(3), quality=95)
    bad = [bufs[0], b"", b"\xff\xd8 not a jpeg", bufs[1][:60], bufs[2]]
    got = decode_batch(bad, SRC, SRC)
    want = rx_decode_batch(bad, SRC, SRC)
    np.testing.assert_array_equal(got, want)
    assert not got[1:4].any() and got[0].any() and got[4].any()
    with pytest.raises(ValueError, match="3/5 images failed to decode"):
        decode_batch(bad, SRC, SRC, strict=True)
    # a plane of the wrong size fails like a corrupt one
    with pytest.raises(ValueError, match="1/1 images"):
        decode_batch(bufs[:1], SRC, SRC + 8, strict=True)
    paths = [str(tmp_path / "a.jpeg"), str(tmp_path / "missing.jpeg")]
    with open(paths[0], "wb") as f:
        f.write(bufs[0])
    got = decode_files(paths, SRC, SRC)
    assert got[0].any() and not got[1].any()
    with pytest.raises(ValueError, match="1/2 files failed to read/decode"):
        decode_files(paths, SRC, SRC, strict=True)


def test_png_raises_where_rxtpu_falls_back_to_cv2(tmp_path):
    """Departure from rxtpu: rxtpu decodes any PNG through cv2, converting a
    colour one to gray; the port reads 8-bit grayscale PNGs (RxRx1's kind)
    bit-equal to cv2 and raises on other kinds, in decode_batch and
    decode_files, with no cv2 fallback. jpeg_size reads JPEG headers only."""
    import cv2

    plane = _planes(1)[0]
    png = cv2.imencode(".png", plane)[1].tobytes()
    np.testing.assert_array_equal(decode_batch([png], SRC, SRC)[0],
                                  rx_decode_batch([png], SRC, SRC)[0])
    colour = cv2.imencode(".png", np.stack([plane] * 3, axis=-1))[1].tobytes()
    np.testing.assert_array_equal(rx_decode_batch([colour], SRC, SRC)[0], plane)
    with pytest.raises(ValueError, match="colour type 2.*8-bit grayscale"):
        decode_batch([colour], SRC, SRC)
    path = str(tmp_path / "x_s1_w1.png")
    with open(path, "wb") as f:
        f.write(colour)
    with pytest.raises(ValueError, match="x_s1_w1.png.*colour type 2"):
        decode_files([path], SRC, SRC)
    with pytest.raises(NotImplementedError):
        jpeg_size(path)


def test_jpeg_size_equals_rxtpu_probe(synthetic_root, tmp_path):
    root, _ = synthetic_root
    for split in ("train", "test"):
        rows, ctrl = rx_read_metadata_csvs(os.path.join(root, "metadata"), split)
        index = rx_load_metadata(rows, ctrl, split)
        cfg = Config(data=DataConfig(path_data=root, image_ext="jpeg"))
        want = rx_cli._probe_src_size(cfg, index)
        r = index.records[0]
        assert jpeg_size(image_path(root, split, r.experiment, r.plate, r.well, 1, 1)) == (
            want, want)
    rect = np.zeros((40, 56), np.uint8)
    path = str(tmp_path / "r.jpeg")
    with open(path, "wb") as f:
        f.write(encode_batch_jpeg(rect[None])[0])
    assert jpeg_size(path) == (40, 56)
    with open(path, "wb") as f:
        f.write(b"\xff\xd8\xff")
    with pytest.raises(ValueError, match="JPEG header"):
        jpeg_size(path)


def _index_pair(root, split):
    rows, ctrl = rx_read_metadata_csvs(os.path.join(root, "metadata"), split)
    port_rows, port_ctrl = read_metadata_csvs(os.path.join(root, "metadata"), split)
    return rx_load_metadata(rows, ctrl, split), load_metadata(port_rows, port_ctrl, split)


@pytest.mark.parametrize("preload", [True, False])
@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_bytestore_pipeline_bit_equal_to_rxtpu(synthetic_root, mode, preload):
    root, _ = synthetic_root
    rx_index, index = _index_pair(root, "test" if mode == "test" else "train")
    stats = _stats(sorted({r.experiment for r in index.records}))
    kw = dict(seed=5, shuffle=mode == "train", drop_last=mode == "train")
    rx_pipe = RxPipeline(rx_index, RxByteStore(rx_index, root, preload=preload), stats, 5,
                         mode, SRC, decoder_threads=2, **kw)
    store = ByteStore(index, root, preload=preload)
    assert store.preloaded == preload
    pipe = Pipeline(index, store, stats, 5, mode, src_size=SRC, decoder_threads=2, **kw)
    assert len(pipe) == len(rx_pipe) >= 2
    for epoch in (0, 1):
        want, got = list(rx_pipe.epoch(epoch)), list(pipe.epoch(epoch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["id_codes"] == w["id_codes"]
            for k in ("images", "labels", "mean", "std", "valid"):
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    with pytest.raises(ValueError, match="src_size"):
        Pipeline(index, store, stats, 5, mode)


def test_bytestore_records_and_cache(synthetic_root):
    root, _ = synthetic_root
    rx_index, index = _index_pair(root, "train")
    from rxtpu.data.records import all_records as rx_all_records

    assert [r.id_code for r in all_records(index)] == [r.id_code for r in
                                                       rx_all_records(rx_index)]
    store, lazy = ByteStore(index, root), ByteStore(index, root, preload=False)
    rx_store = RxByteStore(rx_index, root, preload=False)
    r = index.records[0]
    assert store.get(r, 2) == lazy.get(r, 2) == rx_store.get(rx_index.records[0], 2)
    assert store.paths(r, 1) == rx_store.paths(rx_index.records[0], 1)
    assert store.n_channels == 6 and not lazy.preloaded


def _triples_and_batches(root, batch=7):
    paths = sorted(glob.glob(os.path.join(root, "*", "*", "*", "*.jpeg")))
    experiments = sorted({p.split(os.sep)[-3] for p in paths})
    images = decode_files(paths, SRC, SRC, strict=True)
    ids = np.array([experiments.index(p.split(os.sep)[-3]) * 6 + int(p[-6]) - 1
                    for p in paths], np.int32)

    def batches():
        for i in range(0, len(paths), batch):
            img = np.zeros((batch, SRC, SRC), np.uint8)
            bid = np.full(batch, -1, np.int32)
            n = len(paths[i:i + batch])
            img[:n], bid[:n] = images[i:i + n], ids[i:i + n]
            yield img, bid

    triples = [(experiments[b // 6], b % 6 + 1, im) for im, b in zip(images, ids)]
    return experiments, batches, triples


def test_stats_streaming_bit_equal_to_rxtpu(synthetic_root):
    root, _ = synthetic_root
    experiments, batches, triples = _triples_and_batches(root)
    want = rx_compute_stats_streaming(batches(), experiments)
    got = compute_stats_streaming(batches(), experiments)
    golden = compute_stats_numpy(iter(triples))
    for e in experiments:
        for k in ("mean", "std"):
            assert got[e][k].dtype == np.float64
            np.testing.assert_array_equal(got[e][k], want[e][k], err_msg=f"{e} {k}")
            np.testing.assert_allclose(got[e][k], golden[e][k], rtol=1e-12, atol=0)
    # an experiment with no images gives NaN, as in rxtpu
    got = compute_stats_streaming(batches(), experiments + ["EMPTY-01"])
    assert np.isnan(got["EMPTY-01"]["mean"]).all()


def test_run_stats_writes_rxtpu_json(synthetic_root, tmp_path, capsys):
    root, _ = synthetic_root
    rx_run_stats(root, str(tmp_path / "rx.json"), batch=50)
    port_tools.run_stats(root, str(tmp_path / "port.json"), batch=50, nthreads=2)
    port_tools.main(["stats", "--data", root, "--out", str(tmp_path / "main.json"),
                     "--device", "cpu", "--verify"])
    want = (tmp_path / "rx.json").read_bytes()
    assert (tmp_path / "port.json").read_bytes() == want
    assert (tmp_path / "main.json").read_bytes() == want
    out = capsys.readouterr().out
    assert "Verification:" in out and "wrote" in out
    assert port_tools.list_experiments(root) == sorted(json.loads(want))


def test_jpeg_tree_pipeline_equals_pack_of_its_planes(tmp_path):
    """chip_smoke's JPEG phase at 64^2: the fixture written as a JPEG tree,
    a raw pack of the planes decoded from that tree, and the pipeline's
    batches from the tree equal to the pack's, in every mode."""
    fx = make_train_fixture(str(tmp_path / "fx"), nb_classes=8, n_experiments=2,
                            wells_per_experiment=8, n_test_wells=4, img_size=SRC)
    data = fx["data_dir"]
    n_files = write_jpeg_tree(fx["pack_dir"], data)
    assert n_files == len(glob.glob(os.path.join(data, "*", "*", "*", "*.jpeg")))
    for split, n_wells in (("train", 2 * (8 + 12)), ("test", 4 + 12)):
        rows, ctrl = read_metadata_csvs(os.path.join(data, "metadata"), split)
        index = load_metadata(rows, ctrl, split)
        keys = [(r.experiment, r.plate, r.well, site) for r in all_records(index)
                for site in (1, 2)]
        assert len(keys) == 2 * n_wells
        planes = decode_files([image_path(data, split, *k[:3], k[3], ch) for k in keys
                               for ch in range(1, 7)], SRC, SRC, strict=True)
        write_raw_pack(str(tmp_path / "dec"), split,
                       zip(keys, planes.reshape(len(keys), 6, SRC, SRC)))
        # the tree is lossy: the decoded planes are near the packed ones
        packed = PackStore(os.path.join(fx["pack_dir"], f"{split}.rxpack"))
        orig = packed.get_decoded_batch([(r, s) for r in all_records(index) for s in (1, 2)])
        assert np.abs(orig.astype(int) - planes.reshape(orig.shape)).mean() < 8
        stats = _stats(sorted({r.experiment for r in index.records}))
        dec = PackStore(str(tmp_path / "dec" / f"{split}.rxpack"))
        for mode in (("train", "val") if split == "train" else ("test",)):
            kw = dict(seed=3, shuffle=mode == "train", drop_last=mode == "train")
            want = Pipeline(index, dec, stats, 4, mode, **kw)
            for preload in (True, False):
                pipe = Pipeline(index, ByteStore(index, data, preload=preload), stats, 4, mode,
                                src_size=SRC, decoder_threads=2, **kw)
                for epoch in (0, 1):
                    for g, w in zip(pipe.epoch(epoch), want.epoch(epoch), strict=True):
                        np.testing.assert_array_equal(g["images"], w["images"])
                        assert g["id_codes"] == w["id_codes"]


def test_cli_refuses_png_without_pack():
    """The CLI refuses no image source: PNG input runs with and without
    ``--pack`` (the PNG reader, ``tests/test_torch_port_png_pack.py``)."""
    parse = port_cli.build_argparser().parse_args
    for argv in (["--image-ext", "png"], ["--image-ext", "png", "--pack", "packs"], []):
        assert port_cli._not_ported(parse(argv + ["--device", "cpu"])) is None
    assert port_cli._not_ported(parse(["--profile", "--image-ext", "png"])) is None
    assert "--distributed" in port_cli._not_ported(parse(["--distributed", "--image-ext", "png"]))


def test_nvjpeg_reference_is_rxtpu_decode():
    """``tests/data/jpeg_ref/planes.npz`` (made by ``make_jpeg_ref.py`` with
    rxtpu's decode) equals the port's libjpeg decode of the JPEGs beside it."""
    paths = sorted(glob.glob(os.path.join(REF_DIR, "*.jpeg")))
    ref = np.load(os.path.join(REF_DIR, "planes.npz"))["planes"]
    assert len(paths) == ref.shape[0] == 3 and ref.shape[1:] == (512, 512)
    np.testing.assert_array_equal(decode_files(paths, 512, 512, strict=True), ref)
    np.testing.assert_array_equal(rx_decode_files(paths, 512, 512, strict=True), ref)


@pytest.mark.gpu
def test_nvjpeg_decode_on_card_within_one_level():
    """nvJPEG on the card against rxtpu's libjpeg planes: at most one level
    apart (its IDCT is not libjpeg's), the same planes at 1 and 4 threads,
    from buffers and from files."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the nvJPEG decoder runs only on the card")
    paths = sorted(glob.glob(os.path.join(REF_DIR, "*.jpeg")))
    ref = np.load(os.path.join(REF_DIR, "planes.npz"))["planes"].astype(int)
    bufs = [open(p, "rb").read() for p in paths]
    before = decode_batch.launches
    one = decode_batch(bufs, 512, 512, nthreads=1, strict=True, device="cuda")
    four = decode_batch(bufs, 512, 512, nthreads=4, strict=True, device="cuda")
    files = decode_files(paths, 512, 512, nthreads=2, strict=True, device="cuda")
    torch.cuda.synchronize()
    assert decode_batch.launches == before + 2 and one.is_cuda
    assert torch.equal(one, four) and torch.equal(one, files)
    assert np.abs(one.cpu().numpy().astype(int) - ref).max() <= 1


@pytest.mark.gpu
def test_stats_streaming_on_card_equals_cpu(synthetic_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stats pass runs on the card")
    root, _ = synthetic_root
    experiments, batches, _ = _triples_and_batches(root)
    cpu = compute_stats_streaming(batches(), experiments, device="cpu")
    card = compute_stats_streaming(((torch.from_numpy(i).cuda(), b) for i, b in batches()),
                                   experiments, device="cuda")
    for e in experiments:
        for k in ("mean", "std"):
            np.testing.assert_array_equal(card[e][k], cpu[e][k])
