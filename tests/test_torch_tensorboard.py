"""The port's TensorBoard sink (``mm_s2ut_torch/train/metrics.py``) against
the JAX package's ``MetricsWriter``, which writes through
``tf.summary.create_file_writer`` + ``tf.summary.scalar``: the same steps
and metrics under the ``train`` and ``valid`` prefixes, both events files
read back by TensorFlow's ``summary_iterator`` (which checks every record's
CRCs), equal (tag, step, value, plugin_name) lists, equal ``metrics.csv``.
The port needs no TensorFlow; these tests skip where TensorFlow does not
import, since it is the reference reader."""
import struct

import numpy as np
import pytest

from mm_s2ut_torch.train import metrics as tm

tf = pytest.importorskip("tensorflow")

WRITES = [
    (1, {"loss": 2.75, "nll_loss": 2.5, "ntokens": 812.0, "grad_norm": 0.3125}, "train"),
    (2, {"loss": 2.5, "nll_loss": 2.25, "ntokens": 790.0, "grad_norm": 0.28}, "train"),
    (2, {"loss": 2.9, "nll_loss": 2.7, "ntokens": 400.0}, "valid"),
    (0, {"loss": float("inf"), "lr": 1e-7}, "train"),
    (3 ** 20, {"loss": -1.5e-30, "nan": float("nan")}, "train"),
    (4, {"loss": 123456.789, "nll_loss": 1e30}, "valid"),
]


def scalars(logdir):
    """[(tag, step, float32 value bytes, plugin_name)] of the one events
    file in ``logdir``, and its file_version, through TensorFlow."""
    files = sorted(logdir.glob("events.out.tfevents.*"))
    assert len(files) == 1, files
    out, versions = [], []
    for e in tf.compat.v1.train.summary_iterator(str(files[0])):
        if e.file_version:
            versions.append(e.file_version)
        for v in e.summary.value:
            t = tf.make_ndarray(v.tensor)
            assert t.dtype == np.float32 and t.shape == ()
            out.append((v.tag, e.step, t.tobytes(), v.metadata.plugin_data.plugin_name))
    return out, versions


def write_both(tmp_path, writes):
    from mm_s2ut.train.metrics import MetricsWriter as JWriter

    jw, tw = JWriter(tmp_path / "jax"), tm.MetricsWriter(tmp_path / "port")
    for step, m, prefix in writes:
        jw.write(step, m, prefix=prefix)
        tw.write(step, m, prefix=prefix)
    return tmp_path / "jax", tmp_path / "port"


def test_events_equal_jax_writer(tmp_path):
    jax_dir, port_dir = write_both(tmp_path, WRITES)
    want, want_versions = scalars(jax_dir)
    got, got_versions = scalars(port_dir)
    assert got_versions == want_versions == ["brain.Event:2"]
    assert {p for *_, p in got} == {"scalars"}
    assert len(got) == sum(len(m) for _, m, _ in WRITES)
    assert got == want
    assert (port_dir / "metrics.csv").read_text() == (jax_dir / "metrics.csv").read_text()


@pytest.mark.parametrize("step", [0, 1, 127, 128, 2 ** 40, -5])
def test_event_fields_equal_tensorflow_protobufs(step):
    """The hand-encoded Event parses to what TensorFlow's own protobuf
    classes encode for the same fields, byte for byte."""
    from tensorflow.core.framework import summary_pb2, tensor_pb2, tensor_shape_pb2, types_pb2
    from tensorflow.core.util import event_pb2

    tensor = tensor_pb2.TensorProto(dtype=types_pb2.DT_FLOAT,
                                    tensor_shape=tensor_shape_pb2.TensorShapeProto(),
                                    tensor_content=struct.pack("<f", 0.1))
    value = summary_pb2.Summary.Value(
        tag="train/loss", tensor=tensor, metadata=summary_pb2.SummaryMetadata(
            plugin_data=summary_pb2.SummaryMetadata.PluginData(plugin_name="scalars")))
    want = event_pb2.Event(wall_time=1.5e9 + 0.25, step=step,
                           summary=summary_pb2.Summary(value=[value]))
    got = tm._event(1.5e9 + 0.25, step, summary=tm._field(1, tm._scalar_value("train/loss", 0.1)))
    assert got == want.SerializeToString()
    first = event_pb2.Event.FromString(tm._event(17.0, file_version="brain.Event:2"))
    assert first.file_version == "brain.Event:2" and first.wall_time == 17.0


def test_records_checked_by_tensorflow_reader(tmp_path):
    """``tf.data.TFRecordDataset`` verifies each record's two CRCs; a
    flipped data byte is caught."""
    tw = tm.MetricsWriter(tmp_path)
    tw.write(5, {"loss": 1.0})
    path = next(tmp_path.glob("events.out.tfevents.*"))
    records = [r.numpy() for r in tf.data.TFRecordDataset(str(path))]
    assert len(records) == 2
    assert tm.crc32c(b"123456789") == 0xE3069283  # RFC 3720's check value
    data = bytearray(path.read_bytes())
    data[-6] ^= 1
    path.write_bytes(bytes(data))
    with pytest.raises(tf.errors.DataLossError):
        [r for r in tf.data.TFRecordDataset(str(path))]


def test_values_beyond_float32_are_written_as_infinities(tmp_path):
    """TensorFlow's own summary op raises on a double beyond float32's range
    (JAX's writer would stop the run); the port stores it as float32 does,
    an infinity of its sign, and ``metrics.csv`` keeps the double."""
    tm.MetricsWriter(tmp_path).write(3, {"big": 1e300, "small": -1e300, "ok": 2.0})
    got, _ = scalars(tmp_path)
    assert got == [(f"train/{k}", 3, np.float32(v).tobytes(), "scalars")
                   for k, v in (("big", np.inf), ("small", -np.inf), ("ok", 2.0))]
    assert "1e+300" in (tmp_path / "metrics.csv").read_text()


def test_tensorboard_off_writes_csv_only(tmp_path):
    tw = tm.MetricsWriter(tmp_path, enable_tensorboard=False)
    tw.write(1, {"loss": 1.0})
    assert [p.name for p in tmp_path.iterdir()] == ["metrics.csv"]
