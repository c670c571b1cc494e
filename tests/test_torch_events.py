"""The port's TensorBoard event files (``train/events.py``) read by
TensorBoard's own event loader, and the tags of a training run against the
JAX trainer's tensorboardX files.

Scalars come back as the float32 of the value written; images decode (PIL)
to the arrays written; the port's own reader checks both CRCs of every
record and refuses a corrupted one.
"""

import io
import json
import os

import numpy as np
import pytest
from PIL import Image
from tensorboard.backend.event_processing.event_accumulator import \
    EventAccumulator

from test_trainer import write_config
from vnet_tpu.config import load_config as jax_load_config
from vnet_tpu.train import Trainer as JaxTrainer
from vnet_tpu_torch.__main__ import main
from vnet_tpu_torch.train.events import (FILE_VERSION, PNG_SIGNATURE,
                                         EventWriter, crc32c, encode_png,
                                         event_files, masked_crc32c,
                                         read_events, read_records)


def _load(log_dir):
    acc = EventAccumulator(str(log_dir), size_guidance={"scalars": 0,
                                                        "images": 0})
    acc.Reload()
    return acc


def _decode(png: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(png)))


def test_crc32c_known_answer():
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"") == 0
    assert masked_crc32c(b"") == 0xA282EAD8


def test_png_decodes_to_the_array(rng):
    for shape in ((7, 5, 3), (4, 9, 4), (3, 3, 1)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        png = encode_png(img)
        assert png.startswith(PNG_SIGNATURE)
        got = _decode(png)
        np.testing.assert_array_equal(got.reshape(shape), img)


def test_tensorboard_reads_scalars_and_images(tmp_path, rng):
    w = EventWriter(str(tmp_path))
    scalars = [("loss/0.total_loss", 0.5123, 1), ("learning_rate", 1e-3, 1),
               ("loss/0.total_loss", 0.25, 2), ("perf/big", 3.5e9, 7)]
    for tag, value, step in scalars:
        w.add_scalar(tag, value, step)
    rgb = rng.integers(0, 256, (7, 5, 3)).astype(np.uint8)
    gray = rng.integers(0, 256, (4, 6, 1)).astype(np.uint8)
    rgba = rng.integers(0, 256, (3, 8, 4)).astype(np.uint8)
    w.add_image("img/rgb", rgb, 3)
    w.add_image("img/gray", gray, 3)
    w.add_image("img/rgba", rgba, 4, dataformats="HWC")
    with pytest.raises(ValueError, match="uint8"):
        w.add_image("img/float", rgb.astype(np.float32), 5)
    with pytest.raises(ValueError, match="uint8"):
        w.add_image("img/chw", rgb.transpose(2, 0, 1), 5, dataformats="CHW")
    w.close()

    acc = _load(tmp_path)
    tags = acc.Tags()
    assert sorted(tags["scalars"]) == sorted({t for t, _, _ in scalars})
    for tag in tags["scalars"]:
        expect = [(s, np.float32(v)) for t, v, s in scalars if t == tag]
        got = [(e.step, np.float32(e.value)) for e in acc.Scalars(tag)]
        assert got == expect
    assert sorted(tags["images"]) == ["img/gray", "img/rgb", "img/rgba"]
    expect = {"img/rgb": rgb, "img/gray": gray[..., 0], "img/rgba": rgba}
    for tag, img in expect.items():
        (event,) = acc.Images(tag)
        assert (event.height, event.width) == img.shape[:2]
        np.testing.assert_array_equal(_decode(event.encoded_image_string),
                                      img)

    events = read_events(w.path)
    assert events[0]["file_version"] == FILE_VERSION
    assert [(e["step"], e["values"][0]["tag"]) for e in events[1:5]] == [
        (s, t) for t, _, s in scalars]
    assert events[-1]["values"][0]["image"]["colorspace"] == 4


def test_reader_refuses_a_corrupted_record(tmp_path):
    w = EventWriter(str(tmp_path))
    w.add_scalar("a", 1.0, 1)
    w.close()
    assert len(list(read_records(w.path))) == 2
    blob = bytearray(open(w.path, "rb").read())
    blob[-6] ^= 0x01  # a byte of the last record's data
    open(w.path, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="CRC"):
        list(read_records(w.path))


def _tags(log_dir):
    acc = _load(log_dir)
    t = acc.Tags()
    return {"scalars": set(t["scalars"]), "images": set(t["images"])}


def test_tags_equal_the_jax_trainer_tensorboardx(tmp_path, rng):
    """One tiny ``ImageLog: true`` run with inline testing: each tag
    directory holds the JAX trainer's scalar and image tags, and the port's
    ``scalars.jsonl`` the same scalar tags as its events."""
    cpath = write_config(tmp_path, rng, batch_size=1, max_iterations=3,
                         testing=True, ImageLog=True, LogInterval=1,
                         TestStep=1)
    trainer = JaxTrainer(jax_load_config(cpath), log=True)
    trainer.train()
    for w in trainer._writers.values():
        w.close()
    tree = json.loads(open(cpath).read())
    ts = tree["TrainingSetting"]
    ts.update(LogDir=str(tmp_path / "port_log"),
              CheckpointDir=str(tmp_path / "port_ckpt"))
    port_cfg = tmp_path / "port.json"
    port_cfg.write_text(json.dumps(tree))
    main(["-p", "train", "--config_json", str(port_cfg), "--device", "cpu"])

    for tag in ("train", "test"):
        jax_tags = _tags(tmp_path / "log" / tag)
        port_dir = tmp_path / "port_log" / tag
        port_tags = _tags(port_dir)
        assert port_tags == jax_tags, tag
        assert jax_tags["images"] and "loss/0.total_loss" in \
            jax_tags["scalars"]
        with open(port_dir / "scalars.jsonl") as f:
            jsonl = {json.loads(line)["tag"] for line in f}
        assert jsonl == port_tags["scalars"]
        assert len(event_files(str(port_dir))) == 1
    assert os.path.exists(tmp_path / "port_ckpt" / "network_config.json")
