"""The port's TensorBoard event writer (utils/tensorboard.py), bin/logs_to_tb
and fit(tensorboard_dir=...) against the JAX package's writer. Records are
parsed here in Python (TFRecord framing, masked CRC32C and the Event
protobuf), with no TensorFlow: the same scalars give byte-equal records
but for each record's wall_time."""

import json
import os
import struct

import numpy as np
import pytest
import torch

from ground_plane_polling_tpu.bin import logs_to_tb as jax_logs_to_tb
from ground_plane_polling_tpu.utils import tensorboard as jax_tb
from ground_plane_polling_tpu_torch.bin import logs_to_tb
from ground_plane_polling_tpu_torch.training.loop import fit
from ground_plane_polling_tpu_torch.training.train import TrainState
from ground_plane_polling_tpu_torch.utils import tensorboard as tb

torch.set_num_threads(2)


def _records(path):
    """The payloads of a TFRecord file, each frame's two CRCs checked."""
    data = open(path, "rb").read()
    out, at = [], 0
    while at < len(data):
        header = data[at:at + 8]
        (n,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[at + 8:at + 12])
        assert crc == tb._masked_crc(header)
        payload = data[at + 12:at + 12 + n]
        (crc,) = struct.unpack("<I", data[at + 12 + n:at + 16 + n])
        assert crc == tb._masked_crc(payload)
        out.append(payload)
        at += 16 + n
    return out


def _varint(buf, at):
    shift = value = 0
    while True:
        b = buf[at]
        value |= (b & 0x7F) << shift
        at += 1
        if not b & 0x80:
            return value, at
        shift += 7


def _fields(buf):
    """{field number: [values]} of a protobuf message (wire types 0, 1, 2,
    5)."""
    out, at = {}, 0
    while at < len(buf):
        key, at = _varint(buf, at)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, at = _varint(buf, at)
        elif wire == 1:
            value, at = struct.unpack("<d", buf[at:at + 8])[0], at + 8
        elif wire == 5:
            value, at = struct.unpack("<f", buf[at:at + 4])[0], at + 4
        else:
            n, at = _varint(buf, at)
            value, at = buf[at:at + n], at + n
        out.setdefault(field, []).append(value)
    return out


def _scalars(payloads):
    """[(step, tag, value)] of the scalar events (the first record is the
    file version)."""
    assert _fields(payloads[0])[3] == [b"brain.Event:2"]
    out = []
    for p in payloads[1:]:
        event = _fields(p)
        value = _fields(_fields(event[5][0])[1][0])
        out.append((event[2][0], value[1][0].decode(), value[2][0]))
    return out


def _without_wall_time(payload):
    """The record with its wall_time (field 1, a double, first) cut."""
    assert payload[0] == (1 << 3) | 1
    return payload[9:]


def _only_file(logdir):
    names = os.listdir(logdir)
    assert len(names) == 1 and names[0].startswith("events.out.tfevents.")
    return os.path.join(logdir, names[0])


SCALARS = [({"loss": 1.5, "mAP": 0.25, "lr": 1e-5, "note": "text",
             "values": [1, 2]}, 0),
           ({"loss": float("nan"), "seconds": 12}, 3),
           ({"loss": -2.0 ** 40, "big": 1e30}, 2 ** 40)]


def test_event_records_equal_jax_writer(tmp_path):
    files = []
    for module, name in ((tb, "port"), (jax_tb, "jax")):
        writer = module.TensorBoardWriter(str(tmp_path / name))
        for scalars, step in SCALARS:
            writer.add_scalars(scalars, step)
        writer.add_scalar("explicit", 0.5, 7, wall_time=123.0)
        writer.close()
        files.append(_records(_only_file(str(tmp_path / name))))
    port, want = files
    assert len(port) == len(want) == 1 + 3 + 2 + 2 + 1
    for a, b in zip(port, want):
        assert _without_wall_time(a) == _without_wall_time(b)
    assert port[-1] == want[-1]  # the same explicit wall_time: every byte
    got = _scalars(port)
    assert got[:3] == [(0, "loss", 1.5), (0, "mAP", 0.25),
                       (0, "lr", pytest.approx(1e-5))]
    assert np.isnan(got[3][2]) and got[4] == (3, "seconds", 12.0)


def test_crc32c_and_file_names(tmp_path):
    assert tb._crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    assert tb._masked_crc(b"abc") == jax_tb._masked_crc(b"abc")
    first = tb.TensorBoardWriter(str(tmp_path))
    second = tb.TensorBoardWriter(str(tmp_path))
    first.close()
    second.close()
    assert len(os.listdir(tmp_path)) == 2  # a writer never shares a file


def _log(path):
    records = [{"epoch": 0, "loss": 2.0, "lr": 1e-5, "mAP": 0.5,
                "checkpoint": "/snaps/step_00000002.pt"},
               {"epoch": 1, "loss": 1.75, "lr": 1e-6,
                "lr_reduced_to": 1e-6},
               {"epoch": 2, "error": "non-finite loss",
                "loss_values": [1.0, float("nan")]}]
    with open(path, "w") as f:
        f.write("\n".join(json.dumps(r) for r in records) + "\n\n")


def test_logs_to_tb_matches_jax_cli(tmp_path, capsys):
    log = str(tmp_path / "log.jsonl")
    _log(log)
    assert logs_to_tb.main([log, str(tmp_path / "port")]) == 3
    jax_logs_to_tb.main([log, str(tmp_path / "jax")])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"wrote 3 records to {tmp_path / 'port'}"
    assert out[1] == f"wrote 3 records to {tmp_path / 'jax'}"
    port = _records(_only_file(str(tmp_path / "port")))
    want = _records(_only_file(str(tmp_path / "jax")))
    assert [_without_wall_time(p) for p in port] == \
        [_without_wall_time(p) for p in want]
    assert _scalars(port) == [(0, "loss", 2.0), (0, "lr", pytest.approx(1e-5)),
                              (0, "mAP", 0.5), (1, "loss", 1.75),
                              (1, "lr", pytest.approx(1e-6)),
                              (1, "lr_reduced_to", pytest.approx(1e-6))]


def test_logs_to_tb_step_key(tmp_path):
    log = str(tmp_path / "log.jsonl")
    _log(log)
    assert logs_to_tb.main([log, str(tmp_path / "tb"), "--step-key",
                            "mAP"]) == 3
    steps = [s for s, _, _ in _scalars(_records(_only_file(
        str(tmp_path / "tb"))))]
    # mAP 0.5 -> step 0; records without it take their index
    assert sorted(set(steps)) == [0, 1, 2]


def test_fit_mirrors_each_epoch_into_tensorboard(tmp_path):
    """fit(tensorboard_dir=...): each epoch's record as scalars at its
    epoch, the JSONL log beside it."""
    model = torch.nn.Linear(1, 1)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))

    class Loader:
        def __len__(self):
            return 1

        def epoch(self):
            return iter([None])

    def step(state, _):
        state.step += 1
        return state, {"loss": torch.tensor(1.0 / state.step)}

    log = str(tmp_path / "log.jsonl")
    fit(model, state, step, Loader(), epochs=2, log_path=log,
        tensorboard_dir=str(tmp_path / "tb"), verbose=False)
    got = _scalars(_records(_only_file(str(tmp_path / "tb"))))
    assert ("loss" in {t for _, t, _ in got}
            and {s for s, _, _ in got} == {0, 1})
    assert [v for _, t, v in got if t == "loss"] == [1.0, 0.5]
    assert [json.loads(line)["loss"] for line in open(log)] == [1.0, 0.5]
