"""The port's frozen-graph importer against the JAX package's: the same
constants from the same ``.pb`` bytes (names, dtypes, bytes), the same
errors on the same corrupted bytes, the same assembled trees leaf by leaf,
and random constants at the published inception_v2 widths."""
import numpy as np
import pytest

from pb_graph_writer import write_graph
from test_od_api_import import build_od_api_consts

from glomeruli_segmentation_tpu.convert import pb_import as jax_pb
from glomeruli_segmentation_tpu_torch.convert import pb_import as port_pb


def _same_consts(got, want):
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        assert got[name].tobytes() == want[name].tobytes(), name


@pytest.mark.parametrize("seed,num_classes", [(0, 1), (5, 2)])
def test_constants_from_a_pb_match_jax(tmp_path, seed, num_classes):
    consts, _, _ = build_od_api_consts(seed=seed, num_classes=num_classes)
    path = str(tmp_path / "frozen_inference_graph.pb")
    write_graph(consts, path)
    got = port_pb.load_frozen_graph_constants(path)
    _same_consts(got, jax_pb.load_frozen_graph_constants(path))
    _same_consts(got, {k: np.asarray(v) for k, v in consts.items()})


def _outcome(load, path):
    try:
        return "ok", load(path)
    except Exception as e:  # the type and message are compared
        return type(e).__name__, str(e)


def test_corrupt_pb_gives_the_same_outcome_as_jax(tmp_path):
    """The JAX package's fuzz cases (truncations, random byte damage, huge
    varints): both parsers return the same constants or raise the same
    error."""
    consts, _, _ = build_od_api_consts(seed=7)
    base_path = str(tmp_path / "graph.pb")
    write_graph(consts, base_path)
    base = open(base_path, "rb").read()
    rng = np.random.RandomState(0)
    cases = [("trunc-head", base[:8]),
             ("trunc-quarter", base[: len(base) // 4]),
             ("trunc-3quarter", base[: 3 * len(base) // 4])]
    for k in range(60):
        buf = bytearray(base)
        for _ in range(rng.randint(1, 6)):
            buf[rng.randint(0, len(buf))] = rng.randint(0, 256)
        cases.append((f"rand{k}", bytes(buf)))
    for k, pos in enumerate(rng.randint(0, len(base) - 12, size=12)):
        buf = bytearray(base)
        buf[pos: pos + 10] = b"\xff" * 9 + b"\x7f"  # 63-bit varint
        cases.append((f"hugevarint{k}", bytes(buf)))
    kinds = set()
    for name, data in cases:
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        got = _outcome(port_pb.load_frozen_graph_constants, path)
        want = _outcome(jax_pb.load_frozen_graph_constants, path)
        assert got[0] == want[0], name
        if got[0] == "ok":
            _same_consts(got[1], want[1])
        else:
            assert got[1] == want[1], name
        kinds.add(got[0])
    assert "ok" in kinds and len(kinds) > 1, kinds


def _tensor_bytes(dims, dtype=1):
    def varint(v):
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b7 | 0x80])
            else:
                return out + bytes([b7])

    def field(num, wire, payload):
        tag = varint(num << 3 | wire)
        if wire == 0:
            return tag + varint(payload)
        return tag + varint(len(payload)) + payload

    shape = b"".join(field(2, 2, field(1, 0, d)) for d in dims)
    return field(1, 0, dtype) + field(2, 2, shape)


@pytest.mark.parametrize("dims", [(1 << 40,), (1 << 16, 1 << 16)])
def test_implausible_tensor_count_rejected_like_jax(dims):
    buf = _tensor_bytes(dims)
    with pytest.raises(ValueError, match="implausible") as got:
        port_pb._parse_tensor(buf)
    with pytest.raises(ValueError, match="implausible") as want:
        jax_pb._parse_tensor(buf)
    assert str(got.value) == str(want.value)


def test_splat_and_unknown_dtypes_parse_like_jax():
    # one float_val for a (4, 4) shape (splat), and an unknown dtype code
    splat = _tensor_bytes((4, 4)) + b"\x2a\x04" + np.float32(2.5).tobytes()
    for buf in (splat, _tensor_bytes((3,), dtype=77)):
        got, want = port_pb._parse_tensor(buf), jax_pb._parse_tensor(buf)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(port_pb._parse_tensor(splat),
                                  np.full((4, 4), 2.5, np.float32))


def _same_tree(got, want, path=""):
    assert isinstance(got, dict) and set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _same_tree(got[k], want[k], f"{path}/{k}")
        else:
            a, b = got[k], np.asarray(want[k])
            assert a.dtype == b.dtype and a.shape == b.shape, f"{path}/{k}"
            assert a.tobytes() == b.tobytes(), f"{path}/{k}"


@pytest.mark.parametrize("seed,num_classes", [(3, 1), (9, 2)])
def test_assembled_tree_matches_jax_leaf_by_leaf(tmp_path, seed,
                                                 num_classes):
    consts, _, _ = build_od_api_consts(seed=seed, num_classes=num_classes)
    got, got_classes = port_pb.assemble_od_api_params(consts)
    want, want_classes = jax_pb.assemble_od_api_params(consts)
    assert got_classes == want_classes == num_classes
    _same_tree(got, want)
    path = str(tmp_path / "g.pb")
    write_graph(consts, path)
    from_pb, n = port_pb.load_od_api_detector_params(path)
    assert n == num_classes
    _same_tree(from_pb, want)
    assert port_pb._BN_EPSILON == jax_pb._BN_EPSILON == 0.001


def _unmapped_cases():
    consts, _, _ = build_od_api_consts(seed=6)
    extra = dict(consts)
    extra["MysteryHead/weights"] = np.zeros((1, 1, 4, 4), np.float32)
    no_trunk = {"scope/weights": np.zeros((1, 1, 3, 4), np.float32)}
    no_5c = {k: v for k, v in consts.items() if "Mixed_5c" not in k}
    no_fg = dict(consts)
    no_fg["SecondStageBoxPredictor/ClassPredictor/weights"] = \
        consts["SecondStageBoxPredictor/ClassPredictor/weights"][:, :1]
    no_fg["SecondStageBoxPredictor/ClassPredictor/biases"] = \
        consts["SecondStageBoxPredictor/ClassPredictor/biases"][:1]
    no_rpn = {k: v for k, v in consts.items() if not k.startswith("Conv/")}
    return [extra, no_trunk, no_5c, no_fg, no_rpn]


@pytest.mark.parametrize("case", range(5))
def test_unmapped_weights_errors_match_jax(case):
    consts = _unmapped_cases()[case]
    with pytest.raises(port_pb.UnmappedWeightsError) as got:
        port_pb.assemble_od_api_params(consts)
    with pytest.raises(jax_pb.UnmappedWeightsError) as want:
        jax_pb.assemble_od_api_params(consts)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


@pytest.fixture(scope="module")
def random_consts():
    # full width; a small calibration window and few proposals on the CPU
    return port_pb.random_od_api_consts(0, device="cpu",
                                        calib_size=(96, 96),
                                        calib_proposals=8)


def test_random_consts_have_the_published_widths(random_consts):
    params, num_classes = jax_pb.assemble_od_api_params(random_consts)
    assert num_classes == 1
    first, second = params["first"], params["second"]
    assert first["Conv2d_1a_7x7"]["dw"].shape == (7, 7, 3, 8)
    assert first["Conv2d_1a_7x7"]["pw"].shape == (1, 1, 24, 64)
    assert first["Conv2d_2b_1x1"]["w"].shape == (1, 1, 64, 64)
    assert first["Conv2d_2c_3x3"]["w"].shape == (3, 3, 64, 192)

    def outs(block):
        return sorted((b, c, v["w"].shape[3]) for b, convs in block.items()
                      for c, v in convs.items())

    assert outs(first["Mixed_3b"]) == [
        ("Branch_0", "Conv2d_0a_1x1", 64), ("Branch_1", "Conv2d_0a_1x1", 64),
        ("Branch_1", "Conv2d_0b_3x3", 64), ("Branch_2", "Conv2d_0a_1x1", 64),
        ("Branch_2", "Conv2d_0b_3x3", 96), ("Branch_2", "Conv2d_0c_3x3", 96),
        ("Branch_3", "Conv2d_0b_1x1", 32)]
    assert outs(first["Mixed_4a"]) == [
        ("Branch_0", "Conv2d_0a_1x1", 128), ("Branch_0", "Conv2d_1a_3x3", 160),
        ("Branch_1", "Conv2d_0a_1x1", 64), ("Branch_1", "Conv2d_0b_3x3", 96),
        ("Branch_1", "Conv2d_1a_3x3", 96)]
    assert outs(second["Mixed_5c"]) == [
        ("Branch_0", "Conv2d_0a_1x1", 352), ("Branch_1", "Conv2d_0a_1x1", 192),
        ("Branch_1", "Conv2d_0b_3x3", 320), ("Branch_2", "Conv2d_0a_1x1", 192),
        ("Branch_2", "Conv2d_0b_3x3", 224), ("Branch_2", "Conv2d_0c_3x3", 224),
        ("Branch_3", "Conv2d_0b_1x1", 128)]
    # the trunks' input widths: 576 into the RPN and Mixed_5a, 1024 out
    assert params["rpn_conv"]["w"].shape == (3, 3, 576, 512)
    assert second["Mixed_5a"]["Branch_0"]["Conv2d_0a_1x1"]["w"].shape[2] == 576
    assert params["rpn_cls"]["w"].shape == (1, 1, 512, 24)
    assert params["rpn_box"]["w"].shape == (1, 1, 512, 48)
    assert params["fc_cls"]["w"].shape == (1024, 2)
    assert params["fc_box"]["w"].shape == (1024, 4)
    # every BN scope carries calibrated statistics
    variances = [v for k, v in random_consts.items()
                 if k.endswith("moving_variance")]
    # the stem, 2b, 2c; 8 standard blocks of 7 convs, 2 downsample of 5
    assert len(variances) == 1 + 2 + 8 * 7 + 2 * 5
    assert all(np.isfinite(v).all() and (v >= 0).all() for v in variances)


def test_random_consts_are_seeded(random_consts):
    again = port_pb.random_od_api_consts(0, device="cpu", calib_size=(96, 96),
                                         calib_proposals=8)
    _same_consts(again, random_consts)
    other = port_pb.random_od_api_consts(1, device="cpu", calib_size=(96, 96),
                                         calib_proposals=8, num_classes=2)
    assert other["SecondStageBoxPredictor/ClassPredictor/biases"].shape == (3,)
    assert not np.array_equal(other["Conv/weights"],
                              random_consts["Conv/weights"])
