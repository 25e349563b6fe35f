"""The port's frozen-TF-graph converter (``smmdax_torch.eval.tf_graph``)
against the JAX package's (``smmdax/eval/tf_graph.py``) on real TF graphs
of the FID Inception architecture with random weights, built by the JAX
package's own test builder (``tests/test_tf_graph.py``).

Both converters are pure numpy; the port's output equals JAX's bit for bit
after HWIO -> OIHW, on canonical and permuted branch orders and the 2015
graph's BatchNormWithGlobalNormalization form, and it rejects the same
graphs.
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from smmdax.eval import inception as jinc  # noqa: E402
from smmdax.eval import tf_graph as jtg  # noqa: E402
from smmdax_torch.eval import features as tfeatures  # noqa: E402
from smmdax_torch.eval import inception as tinc  # noqa: E402
from smmdax_torch.eval import tf_graph as ttg  # noqa: E402
from test_tf_graph import _rand_weights, build_fid_graph  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: F401,E402  (autouse)

PERMUTED = {"Mixed_5c": [2, 0, 3, 1], "Mixed_5d": [1, 2, 3, 0], "Mixed_6a": [1, 2, 0],
            "Mixed_6d": [3, 1, 0, 2], "Mixed_6e": [0, 3, 2, 1], "Mixed_7a": [2, 1, 0],
            "Mixed_7b": [1, 3, 0, 2], "Mixed_7b.split": [1, 0]}


def _equal_to_jax(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        w = np.asarray(v["w"])
        np.testing.assert_array_equal(got[k]["w"], w if k == "fc" else w.transpose(3, 2, 0, 1),
                                      err_msg=k)
        np.testing.assert_array_equal(got[k]["b"], np.asarray(v["b"]), err_msg=k)
        assert got[k]["w"].dtype == np.float32 and got[k]["w"].flags.c_contiguous


def _graph_bytes(weights, orders=None):
    g, *_ = build_fid_graph(weights, orders=orders)
    return g.as_graph_def().SerializeToString()


def test_wire_parser_reads_tf_consts():
    big = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    g = tf.Graph()
    with g.as_default():
        tf.constant(big, name="big")
        tf.constant(np.float32(2.5), name="scalar")
        tf.constant([1, 2, 3], dtype=tf.int32, name="ints")
        tf.nn.max_pool2d(tf.constant(np.ones((1, 4, 4, 2), np.float32)), 3, 2, "SAME",
                         name="pool")
    nodes = {n.name: n for n in ttg.parse_graph_def(g.as_graph_def().SerializeToString())}
    np.testing.assert_array_equal(nodes["big"].attrs["value"].tensor, big)
    assert nodes["scalar"].attrs["value"].tensor == np.float32(2.5)
    np.testing.assert_array_equal(nodes["ints"].attrs["value"].tensor, [1, 2, 3])
    assert nodes["pool"].op == "MaxPool" and nodes["pool"].attrs["ksize"].list_i == [1, 3, 3, 1]
    assert nodes["pool"].attrs["padding"].s == b"SAME"


@pytest.mark.parametrize("orders", [None, PERMUTED], ids=["canonical", "permuted"])
def test_convert_equals_jax(orders):
    data = _graph_bytes(_rand_weights(seed=1), orders)
    got, meta = ttg.convert_frozen_graph(data, return_meta=True)
    want, want_meta = jtg.convert_frozen_graph(data, return_meta=True)
    _equal_to_jax(got, want)
    assert meta == want_meta == {"Mixed_7b_pool": "avg", "Mixed_7c_pool": "max"}
    assert got["fc"]["w"].shape == (2048, 1008)


@pytest.mark.parametrize("scale_after_norm", [True, False])
def test_bnwgn_form_equals_jax(scale_after_norm):
    """The 2015 graph's BatchNormWithGlobalNormalization op in place of
    FusedBatchNormV3 (inputs reordered, attrs renamed)."""
    gd = build_fid_graph(_rand_weights(seed=2))[0].as_graph_def()
    rewritten = tf.compat.v1.GraphDef()
    for node in gd.node:
        new = rewritten.node.add()
        if node.op == "FusedBatchNormV3":
            x_in, scale, offset, mean, var = node.input[:5]
            new.name, new.op = node.name, "BatchNormWithGlobalNormalization"
            new.input.extend([x_in, mean, var, offset, scale])
            new.attr["T"].type = tf.float32.as_datatype_enum
            new.attr["variance_epsilon"].f = jinc.BN_EPS
            new.attr["scale_after_normalization"].b = scale_after_norm
        else:
            new.CopyFrom(node)
    data = rewritten.SerializeToString()
    _equal_to_jax(ttg.convert_frozen_graph(data), jtg.convert_frozen_graph(data))


def test_bad_pool_geometry_rejected():
    gd = build_fid_graph(_rand_weights(seed=4))[0].as_graph_def()
    bad = tf.compat.v1.GraphDef()
    for node in gd.node:
        new = bad.node.add()
        new.CopyFrom(node)
        if node.op == "AvgPool" and list(node.attr["ksize"].list.i) == [1, 3, 3, 1]:
            new.attr["ksize"].list.i[:] = [1, 5, 5, 1]
    data = bad.SerializeToString()
    for convert in (jtg.convert_frozen_graph, ttg.convert_frozen_graph):
        with pytest.raises(ValueError, match="pool geometry"):
            convert(data)


def test_fc_width_against_pool_kind_rejected(tmp_path):
    """A 1008-way fc (auto: FID semantics, a max pool in Mixed_7c) over a
    graph whose Mixed_7c pool is an average: load_params refuses it."""
    import test_tf_graph as jt
    w = _rand_weights(seed=6)
    g = tf.Graph()
    with g.as_default():
        raw = tf.compat.v1.placeholder(tf.float32, [None, 299, 299, 3])
        x = tf.multiply(tf.subtract(raw, 128.0), 1.0 / 128.0)
        for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
            x = jt._conv(x, name, w)
        x = tf.nn.max_pool2d(x, 3, 2, "VALID")
        x = jt._conv(jt._conv(x, "Conv2d_3b_1x1", w), "Conv2d_4a_3x3", w)
        x = tf.nn.max_pool2d(x, 3, 2, "VALID")
        for p in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = jt._block_a(x, p, w)
        x = jt._block_b(x, w)
        for p in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = jt._block_c(x, p, w)
        x = jt._block_d(x, w)
        x = jt._block_e(x, "Mixed_7b", w, pool_max=False)
        x = jt._block_e(x, "Mixed_7c", w, pool_max=False)
        pool3 = tf.reshape(tf.nn.avg_pool2d(x, 8, 1, "VALID"), [-1, 2048])
        tf.nn.bias_add(tf.linalg.matmul(pool3, tf.constant(w["fc"]["w"])),
                       tf.constant(w["fc"]["b"]))
    pb = tmp_path / "odd.pb"
    pb.write_bytes(g.as_graph_def().SerializeToString())
    for load in (jinc.load_params, tinc.load_params):
        with pytest.raises(ValueError, match="fid_semantics"):
            load(str(pb))


def test_load_params_dispatches_pb(tmp_path):
    pb = tmp_path / "classify_image_graph_def.pb"
    pb.write_bytes(_graph_bytes(_rand_weights(seed=3)))
    _equal_to_jax(tinc.load_params(str(pb)), jinc.load_params(str(pb)))
    assert tfeatures.find_inception_weights(str(tmp_path)) == str(pb)
    ext = tfeatures.get_feature_extractor(str(tmp_path), device="cpu")
    assert isinstance(ext, tfeatures.InceptionFeatures) and ext._net.fid_semantics is True
    imgs = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    feats, probs = ext.features_and_probs(imgs)
    assert feats.shape == (2, 2048) and probs.shape == (2, 1008)
    assert np.isfinite(feats).all() and np.isfinite(probs).all()
