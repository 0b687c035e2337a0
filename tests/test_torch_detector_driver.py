"""The port's native detector trainer (``train/detector_driver.py``, the
training form of ``models/faster_rcnn.py``, ``convert/detector_import.py``'s
way back) against the JAX package's on the CPU.

- The window sampler gives byte-identical batches for equal seeds, on the
  JAX tests' annotated-tree layout, and the trainer trains on the JAX
  driver's windows (its first draw goes to ``model.init``).
- Two training steps of the tiny backbone from a JAX ``model.init`` carried
  across, with ``roi_chunk`` 6 (three second-stage chunks of the 16
  proposals), the second step from the JAX state after the first (Adam's
  moments carried too).  The JAX step (``train_detector``'s, verbatim) is
  evaluated in float64 (``jax.enable_x64``): in float32 its BatchNorm
  statistics carry the cancellation of Flax's fast variance ``E[x^2] -
  E[x]^2`` where a conv's output mean is large against its spread, as on
  the first layer (``test_train_mode_batch_variance_is_two_pass``), more
  than the bars below allow.  The port's float32 step is held to it:
  losses within 1e-5 relative, BN running statistics within 1e-6; the
  gradients within 1e-4 of the largest one, or no further from the float64
  step than the JAX package's own float32 gradient is (after one Adam step
  the BN gradients cancel more, and float32 rounding moves them further);
  after the first step the parameters within 1e-5.  Adam's first
  update is ``-lr * g / (|g| + 1e-8)``: where ``|g|`` is under 1000 eps
  the update turns on the gradient's float32 rounding (it moves the update
  by ``lr * eps * dg / |g|^2``), so those elements (found from the float64
  step's own second moment) are held to Adam's bound of two lr instead,
  and at most 5% of the elements may be such.
- ``detector.ckpt.pth`` read both ways: the port's loads in the JAX
  package and detects what the port detects; the JAX trainer's loads in
  the port's training form.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from glomeruli_segmentation_tpu.cli import detect as jax_detect_cli
from glomeruli_segmentation_tpu.convert.torch_pickle import (
    load_torch_pickle,
    save_torch_legacy,
)
from glomeruli_segmentation_tpu.models import faster_rcnn as jax_frcnn
from glomeruli_segmentation_tpu.pipeline import detect as jax_detect
from glomeruli_segmentation_tpu.train import detector_driver as jax_driver
from glomeruli_segmentation_tpu.train.detector_train import (
    detector_loss as jax_detector_loss,
)
from glomeruli_segmentation_tpu.wsi.synthetic import (
    pas_like_image,
    write_pyramidal_tiff,
)
from glomeruli_segmentation_tpu_torch.cli import detect as port_detect_cli
from glomeruli_segmentation_tpu_torch.convert import detector_import
from glomeruli_segmentation_tpu_torch.convert.detector_import import (
    flax_from_state_dict,
    load_detector_checkpoint,
    save_detector_checkpoint,
    state_dict_from_flax,
)
from glomeruli_segmentation_tpu_torch.models import faster_rcnn as port_frcnn
from glomeruli_segmentation_tpu_torch.models import resnet as port_resnet
from glomeruli_segmentation_tpu_torch.pipeline import detect as port_detect
from glomeruli_segmentation_tpu_torch.train import detector_driver

PATIENT = "H16-22222"
LR, STEPS = 1e-3, 2
LOSS_RTOL, STATS_ATOL, PARAM_ATOL, GRAD_RTOL = 1e-5, 1e-6, 1e-5, 1e-4
ILL_CONDITIONED = 1000 * 1e-8         # sqrt of Adam's corrected v below this
BF16_RTOL = 5e-2
TINY = dict(image_size=(128, 128), backbone="tiny",
            anchor_scales=(0.25, 0.5), anchor_aspects=(1.0,),
            anchor_base=128.0, pre_nms_top_n=128, post_nms_top_n=16,
            crop_size=8, max_detections=8, roi_chunk=6)


@pytest.fixture(scope="module")
def annotated_tree(tmp_path_factory):
    """The JAX tests' layout (``tests/test_detector_driver.py``): one
    pyramidal TIFF with four glomeruli and its Pascal-VOC XML at ds8."""
    tmp = tmp_path_factory.mktemp("det")
    img, centers = pas_like_image(1536, 2048, seed=31, n_glomeruli=4)
    pdir = tmp / "data" / "02_PAS" / PATIENT
    (pdir / "annotations").mkdir(parents=True)
    write_pyramidal_tiff(str(pdir / f"{PATIENT}.tiff"), img, mpp=0.25,
                         objective_power=40.0, levels=4)
    objs = ""
    for cx, cy, r in centers:
        x1, y1 = (cx - r) // 8, (cy - r) // 8
        x2, y2 = (cx + r) // 8, (cy + r) // 8
        objs += (f"<object><name>glomerulus</name><bndbox>"
                 f"<xmin>{x1}</xmin><ymin>{y1}</ymin>"
                 f"<xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>")
    (pdir / "annotations" / f"OPT_PAS_{PATIENT}_{PATIENT}_pw40_ds8.xml"
     ).write_text(f"<annotation>{objs}</annotation>")
    target = tmp / "targets.txt"
    target.write_text(f"{PATIENT}/{PATIENT}\n")
    return tmp


def _samplers(tree, **kw):
    args = ("OPT_PAS", str(tree / "data"), str(tree / "targets.txt"))
    return (jax_driver.SlideWindowSampler(
                *args, jax_driver.DetectorTrainConfig(**kw)),
            detector_driver.SlideWindowSampler(
                *args, detector_driver.DetectorTrainConfig(**kw)))


@pytest.mark.parametrize("seed", [0, 5])
def test_window_sampler_batches_equal_jax(annotated_tree, seed):
    want_s, got_s = _samplers(annotated_tree, image_size=128, batch_size=2,
                              max_gt=8)
    want_rng, got_rng = (np.random.default_rng(seed),
                         np.random.default_rng(seed))
    found = 0
    for draw in range(8):
        want = want_s.sample_batch(want_rng)
        got = got_s.sample_batch(got_rng)
        for g, w, name in zip(got, want, ("images", "boxes", "classes",
                                          "valid")):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert g.tobytes() == w.tobytes(), (name, draw)
        found += int(got[3].sum())
    assert found > 0


def test_config_matches_jax():
    assert dataclasses.asdict(detector_driver.DetectorTrainConfig()) == \
        dataclasses.asdict(jax_driver.DetectorTrainConfig())


def test_trainer_trains_on_the_jax_drivers_windows(annotated_tree, tmp_path,
                                                   monkeypatch):
    """The JAX driver initialises its model on the first draw; the port
    draws it too, so its steps train on draws 2 and 3."""
    seen = []
    sample = detector_driver.SlideWindowSampler.sample_batch

    def recorded(self, rng):
        out = sample(self, rng)
        seen.append(out)
        return out

    monkeypatch.setattr(detector_driver.SlideWindowSampler, "sample_batch",
                        recorded)
    cfg = detector_driver.DetectorTrainConfig(image_size=128, batch_size=2,
                                              steps=2, max_gt=8, seed=3)
    trained = []
    step = detector_driver.train_step

    def recorded_step(model, optimizer, forward, anchors, batch, bf16=False):
        trained.append(batch[0].numpy().astype(np.uint8))
        return step(model, optimizer, forward, anchors, batch, bf16)

    monkeypatch.setattr(detector_driver, "train_step", recorded_step)
    detector_driver.train_detector(
        "OPT_PAS", str(annotated_tree / "data"),
        str(annotated_tree / "targets.txt"), str(tmp_path), cfg,
        port_frcnn.FasterRCNNConfig(**TINY), log_every=1, device="cpu")
    want_s, _ = _samplers(annotated_tree, image_size=128, batch_size=2,
                          max_gt=8)
    rng = np.random.default_rng(3)
    draws = [want_s.sample_batch(rng) for _ in range(3)]
    assert len(seen) == 3
    for got, want in zip(seen, draws):
        assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))
    assert [t.tobytes() for t in trained] == [d[0].tobytes()
                                              for d in draws[1:]]


# ---------------- two training steps against the JAX step ----------------
@pytest.fixture(scope="module")
def jax_steps(annotated_tree):
    """The JAX trainer's step (``train_detector``'s, verbatim) twice from
    ``model.init`` on the first draw, in float64: per step the state
    before it (variables, Adam's mu, nu and count, as float32) and after
    it (the port's state of the variables, the losses, the square root of
    Adam's bias-corrected second moment and the gradients in the port's
    layout), and the distance of the JAX package's float32 gradient from
    the float64 one."""
    want_s, _ = _samplers(annotated_tree, image_size=128, batch_size=2,
                          max_gt=8)
    rng = np.random.default_rng(0)
    batches = [want_s.sample_batch(rng) for _ in range(STEPS + 1)]
    jcfg = jax_frcnn.FasterRCNNConfig(**TINY)
    model = jax_frcnn.FasterRCNN(jcfg)
    anchors = jax_frcnn.build_anchors(jcfg)
    variables = model.init(jax.random.key(0), jnp.asarray(
        batches[0][0], jnp.float32), anchors, train=True)
    params, batch_stats = variables["params"], variables["batch_stats"]
    tx = optax.adam(LR)
    opt_state = tx.init(params)

    def step(params, batch_stats, opt_state, x, gb, gc, gv):
        def loss_fn(p):
            out, upd = model.apply(
                {"params": p, "batch_stats": batch_stats}, x, anchors,
                train=True, mutable=["batch_stats"])
            losses = jax_detector_loss(anchors, out, gb, gc, gv)
            return losses["total"], (losses, upd["batch_stats"])

        (loss, (losses, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), new_stats, opt_state,
                losses, grads)

    @jax.jit
    def grads_f32(params, batch_stats, x, gb, gc, gv):
        """The JAX package's own float32 gradient of the step."""
        def loss_fn(p):
            out, _ = model.apply({"params": p, "batch_stats": batch_stats},
                                 x, anchors32, train=True,
                                 mutable=["batch_stats"])
            return jax_detector_loss(anchors32, out, gb, gc, gv)["total"]
        return jax.grad(loss_fn)(params)

    step = jax.jit(step)
    anchors32 = anchors
    with jax.enable_x64(True):
        f64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                           (params, batch_stats))
        params, batch_stats = f64
        anchors = jnp.asarray(anchors, jnp.float64)
        opt_state = tx.init(params)
        out = _jax_loop(step, params, batch_stats, opt_state, batches[1:])
    # per step: how far the JAX package's float32 gradient lies from the
    # float64 one (the largest difference over the largest gradient)
    f32_distance = []
    for (variables, _), (x, gb, gc, gv), _, _, _, want in out:
        g32 = state_dict_from_flax({
            "params": jax.tree.map(np.asarray, grads_f32(
                variables["params"], variables["batch_stats"],
                np.asarray(x, np.float32), gb, gc, gv)),
            "batch_stats": variables["batch_stats"]})
        f32_distance.append(_grad_distance(g32, want))
    return [step_ + (d,) for step_, d in zip(out, f32_distance)]


def _grad_distance(got, want):
    """The largest gradient difference over the largest gradient, over
    every parameter."""
    keys = [k for k in got if not k.endswith((".bn.mean", ".bn.var"))]
    g_max = max(float(np.abs(want[k].numpy()).max()) for k in keys)
    return max(float(np.abs(got[k].numpy() - want[k].numpy()).max())
               for k in keys) / g_max


def _jax_loop(step, params, batch_stats, opt_state, batches):
    out = []
    for x, gb, gc, gv in batches:
        adam = opt_state[0]
        before = jax.tree.map(lambda a: np.asarray(a, np.float32), (
            {"params": params, "batch_stats": batch_stats},
            (int(adam.count), adam.mu, adam.nu)))
        params, batch_stats, opt_state, losses, grads = step(
            params, batch_stats, opt_state, np.asarray(x, np.float64), gb,
            gc, gv)
        after = jax.tree.map(lambda a: np.asarray(a, np.float32), {
            "params": params, "batch_stats": batch_stats})
        adam = opt_state[0]
        root_v = jax.tree.map(lambda n: np.sqrt(
            np.asarray(n) / (1 - 0.999 ** int(adam.count))), adam.nu)
        grads = jax.tree.map(lambda a: np.asarray(a, np.float32), grads)
        out.append((before, (x, gb, gc, gv), state_dict_from_flax(after),
                    {k: float(v) for k, v in losses.items()},
                    state_dict_from_flax({"params": root_v, "batch_stats":
                                          after["batch_stats"]}),
                    state_dict_from_flax({"params": grads, "batch_stats":
                                          after["batch_stats"]})))
    return out


def _port_model(variables):
    model = port_frcnn.FasterRCNN(port_frcnn.FasterRCNNConfig(**TINY),
                                  kernel_nms=False, train_form=True)
    return model.load_state(state_dict_from_flax(variables))


def _carry_adam(model, optimizer, variables, adam):
    count, mu, nu = adam
    if count == 0:
        return
    stats = variables["batch_stats"]
    mu = state_dict_from_flax({"params": mu, "batch_stats": stats})
    nu = state_dict_from_flax({"params": nu, "batch_stats": stats})
    names = dict(model.named_parameters())
    state = model.detector_state()
    for key in state:
        train_key = next(iter(port_resnet.train_state_dict({key: state[key]})))
        if train_key in names:
            optimizer.state[names[train_key]] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu[key].clone(), "exp_avg_sq": nu[key].clone()}


def _port_step(model, batch, bf16=False):
    optimizer = torch.optim.Adam(model.parameters(), lr=LR, eps=1e-8)
    anchors = port_frcnn.build_anchors(model.config)
    return optimizer, detector_driver.train_step(
        model, optimizer, detector_driver.native_forward, anchors,
        detector_driver.upload_batch(batch, torch.device("cpu")), bf16)


def test_two_f32_steps_match_jax(jax_steps):
    masked = total = 0
    for step, (before, batch, want, want_losses, root_v, want_grads,
               jax_f32) in enumerate(jax_steps):
        variables, adam = before
        model = _port_model(variables)
        optimizer = torch.optim.Adam(model.parameters(), lr=LR, eps=1e-8)
        _carry_adam(model, optimizer, variables, adam)
        losses, proposals = detector_driver.train_step(
            model, optimizer, detector_driver.native_forward,
            port_frcnn.build_anchors(model.config),
            detector_driver.upload_batch(batch, torch.device("cpu")))
        assert list(losses) == ["rpn_cls", "rpn_reg", "roi_cls", "roi_reg",
                                "total"]
        for k, w in want_losses.items():
            assert abs(float(losses[k]) - w) <= LOSS_RTOL * abs(w), \
                (step, k, float(losses[k]), w)
        assert proposals.shape == (2, 16, 4)
        grads = port_resnet.detector_state(
            {k: p.grad for k, p in model.named_parameters()})
        assert grads.keys() == {k for k in want_grads
                                if not k.endswith((".bn.mean", ".bn.var"))}
        # the gradient: within 1e-4 of the largest, or no further from the
        # float64 step than the JAX package's own float32 gradient is
        distance = _grad_distance(grads, want_grads)
        assert distance <= max(GRAD_RTOL, jax_f32), (step, distance, jax_f32)
        got = model.detector_state()
        assert got.keys() == want.keys()
        for key, w in want.items():
            g, w = got[key].numpy(), w.numpy()
            if key.endswith((".bn.mean", ".bn.var")):
                np.testing.assert_allclose(g, w, rtol=0, atol=STATS_ATOL,
                                           err_msg=f"{key} step {step}")
                continue
            if step:
                continue
            ok = root_v[key].numpy() >= ILL_CONDITIONED
            np.testing.assert_allclose(g[ok], w[ok], rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{key} step {step}")
            assert np.all(np.abs(g[~ok] - w[~ok]) <= 2 * LR), key
            masked += int((~ok).sum())
            total += ok.size
    assert masked <= 0.05 * total, (masked, total)


def test_bf16_step_keeps_float32_state(jax_steps):
    """--bf16 autocasts the forward only: its losses within 5e-2 of the
    float32 step's; parameters, gradients, BN statistics and Adam's state
    stay float32."""
    (variables, _), batch, _, want_losses, _, _, _ = jax_steps[0]
    model = _port_model(variables)
    optimizer, (losses, _) = _port_step(model, batch, bf16=True)
    want = want_losses["total"]
    assert abs(float(losses["total"]) - want) <= BF16_RTOL * want
    assert float(losses["total"]) != want
    assert all(v.dtype == torch.float32 for v in losses.values())
    assert all(t.dtype == torch.float32 for k, t in model.state_dict().items()
               if not k.endswith("num_batches_tracked"))
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert all(s.dtype == torch.float32 for st in optimizer.state.values()
               for k, s in st.items() if k != "step")


# ---------------- the training form and the state's way back ----------------
@pytest.fixture(scope="module")
def jax_init(annotated_tree):
    jcfg = jax_frcnn.FasterRCNNConfig(**TINY)
    model = jax_frcnn.FasterRCNN(jcfg)
    x = np.random.RandomState(2).uniform(0, 255, (2, 128, 128, 3))
    return jax.tree.map(np.asarray, model.init(
        jax.random.key(1), jnp.asarray(x, jnp.float32),
        jax_frcnn.build_anchors(jcfg), train=True))


def test_flax_tree_round_trips(jax_init):
    back = flax_from_state_dict(state_dict_from_flax(jax_init))
    assert jax.tree.structure(back) == jax.tree.structure(jax_init)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax_init)):
        assert a.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("backbone,seed", [("tiny", 0), ("tiny", 3),
                                           ("resnet50", 1)])
def test_init_state_is_the_jax_packages_init(backbone, seed):
    """``init_detector_state(seed)`` draws what the JAX package's
    ``model.init(jax.random.key(seed))`` draws: every tensor within a few
    float32 roundings of the largest of it (``erfinv`` is evaluated on
    another path), BN and biases exactly."""
    jcfg = jax_frcnn.FasterRCNNConfig(**dict(TINY, backbone=backbone))
    x = np.random.RandomState(2).uniform(0, 255, (1, 128, 128, 3))
    want = state_dict_from_flax(jax.tree.map(np.asarray, jax_frcnn.FasterRCNN(
        jcfg).init(jax.random.key(seed), jnp.asarray(x, jnp.float32),
                   jax_frcnn.build_anchors(jcfg), train=True)))
    got = detector_import.init_detector_state(seed, port_frcnn.FasterRCNNConfig(
        **dict(TINY, backbone=backbone)))
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if key.endswith(".weight"):
            assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())
        else:
            assert torch.equal(g, w), key


@pytest.mark.parametrize("backbone", ["tiny", "resnet50"])
def test_init_state_has_the_flax_layout(jax_init, backbone):
    """Fresh weights as ``model.init`` lays them out: the same keys and
    shapes, BN at identity, biases zero, kernels of LeCun variance."""
    cfg = port_frcnn.FasterRCNNConfig(**dict(TINY, backbone=backbone))
    state = detector_import.init_detector_state(0, cfg)
    if backbone == "tiny":
        want = state_dict_from_flax(jax_init)
        assert {k: tuple(v.shape) for k, v in state.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
    again = detector_import.init_detector_state(0, cfg)
    assert all(torch.equal(state[k], again[k]) for k in state)
    for key, v in state.items():
        if key.endswith((".bn.scale", ".bn.var")):
            assert torch.all(v == 1), key
        elif key.endswith((".bias", ".bn.mean")):
            assert torch.all(v == 0), key
        else:
            fan_in = v[0].numel()
            assert float(v.abs().max()) <= 2 / 0.8796 / fan_in ** 0.5 + 1e-6
    w = state["backbone.block3.block0.c1.conv.weight"] if \
        backbone == "resnet50" else state["backbone.c3.conv.weight"]
    assert abs(float(w.std()) * w[0].numel() ** 0.5 - 1) < 0.05
    port_frcnn.FasterRCNN(cfg, train_form=True).load_state(state)


def test_training_form_in_eval_mode_equals_the_folded_model(jax_init):
    """Evaluation mode of the training form (BN with running statistics)
    gives the folded inference model's outputs, and its state goes back
    to the detector state unchanged."""
    rng = np.random.RandomState(3)
    state = state_dict_from_flax(jax_init)
    # move the statistics off identity so the fold does something
    for k in state:
        if k.endswith(".bn.mean"):
            state[k] = torch.from_numpy(rng.randn(*state[k].shape)
                                        .astype(np.float32) * 0.1)
        elif k.endswith(".bn.var"):
            state[k] = torch.from_numpy(rng.uniform(0.5, 2, state[k].shape)
                                        .astype(np.float32))
    cfg = port_frcnn.FasterRCNNConfig(**TINY)
    train = port_frcnn.FasterRCNN(cfg, kernel_nms=False,
                                  train_form=True).load_state(state).eval()
    folded = port_frcnn.FasterRCNN(cfg, kernel_nms=False).load_state(
        state).eval()
    x = torch.from_numpy(rng.uniform(0, 255, (2, 128, 128, 3)).astype(
        np.float32))
    anchors = port_frcnn.build_anchors(cfg)
    with torch.no_grad():
        a, b = train(x, anchors), folded(x, anchors)
    for k in ("rpn_objectness", "rpn_deltas"):
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    back = train.detector_state()
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)
    with pytest.raises(ValueError, match="folded"):
        folded.detector_state()


def test_train_mode_updates_bn_once_per_roi_chunk(jax_init):
    """roi_chunk 6 splits the 16 proposals into three chunks: each of the
    box head's BNs takes three momentum-0.003 updates in one forward, the
    backbone's one."""
    state = state_dict_from_flax(jax_init)
    model = port_frcnn.FasterRCNN(port_frcnn.FasterRCNNConfig(**TINY),
                                  kernel_nms=False,
                                  train_form=True).load_state(state).train()
    calls = {}
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.register_forward_hook(
                lambda mod, i, o, name=name: calls.__setitem__(
                    name, calls.get(name, 0) + 1))
    x = torch.from_numpy(np.random.RandomState(4).uniform(
        0, 255, (2, 128, 128, 3)).astype(np.float32))
    model(x, port_frcnn.build_anchors(model.config))
    assert calls["box_head.tiny_head.h0.bn"] == 3
    assert calls["backbone.c0.bn"] == 1


# ---------------- checkpoints both ways ----------------
def _images(seed):
    return np.random.RandomState(seed).randint(
        0, 255, (2, 128, 128, 3)).astype(np.uint8)


def test_port_checkpoint_loads_in_jax_and_detects_the_same(jax_steps,
                                                          tmp_path):
    """A port-written ``detector.ckpt.pth`` (``torch.save``, zip form): the
    JAX package's ``load_backend`` reads it, its tree equals the port's
    state, and in float32 both detect the same windows alike."""
    _, _, state, _, _, _, _ = jax_steps[-1]
    cfg = port_frcnn.FasterRCNNConfig(**TINY)
    path = save_detector_checkpoint(state, cfg,
                                    str(tmp_path / "detector.ckpt.pth"))
    backend = jax_detect_cli.load_backend(str(tmp_path), None, 2)
    assert type(backend).__name__ == "JaxDetectorBackend"
    assert dataclasses.asdict(backend.base_config) == dataclasses.asdict(cfg)
    blob = load_torch_pickle(path)
    tree = jax.tree.map(np.asarray, blob["variables"])
    want = flax_from_state_dict(state)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(tree), jax.tree.leaves(want)))
    images = _images(5)
    jax_out = jax_detect.JaxDetectorBackend(
        jax.tree.map(jnp.asarray, tree), backend.base_config, 2,
        compute_dtype="float32").detect_batch(images)
    port_state, port_cfg = load_detector_checkpoint(path)
    port_out = port_detect.TorchDetectorBackend(
        port_state, port_cfg, 2, compute_dtype="float32",
        device="cpu").detect_batch(images)
    np.testing.assert_array_equal(port_out[3], jax_out[3])
    np.testing.assert_array_equal(port_out[2], jax_out[2])
    np.testing.assert_allclose(port_out[1], jax_out[1], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(port_out[0], jax_out[0], atol=1e-4, rtol=1e-4)
    # and the port's own detect command loads it
    assert isinstance(port_detect_cli.load_backend(
        str(tmp_path), None, 2, device="cpu"),
        port_detect.TorchDetectorBackend)


def test_jax_checkpoint_loads_in_the_training_form(jax_steps, tmp_path):
    """The JAX trainer's ``detector.ckpt.pth`` (the legacy pickle of the
    Flax variables and the config) loads into the port's training form;
    its state is the JAX tree's."""
    _, _, state, _, _, _, _ = jax_steps[-1]
    jcfg = jax_frcnn.FasterRCNNConfig(**TINY)
    path = tmp_path / "detector.ckpt.pth"
    save_torch_legacy({"variables": flax_from_state_dict(state),
                       "config": dataclasses.asdict(jcfg)}, str(path))
    got, cfg = load_detector_checkpoint(str(path))
    assert cfg == port_frcnn.FasterRCNNConfig(**TINY)
    model = port_frcnn.FasterRCNN(cfg, train_form=True).load_state(got)
    back = model.detector_state()
    assert all(torch.equal(back[k], state[k]) for k in state)


def test_train_mode_batch_variance_is_two_pass():
    """The training form's BatchNorms take the batch variance in two
    passes (``train/batch_norm.py``), exact to float32 where the mean is
    large against the spread, as on the first conv of a window: the
    running variance within 1e-6 relative of the float64 value, and at
    least 10x nearer to it than Flax's fast variance ``E[x^2] - E[x]^2``
    (the JAX package's ``nn.BatchNorm``), which is why the step test runs
    the JAX step in float64."""
    from flax import linen as flax_nn

    rng = np.random.RandomState(6)
    x = (rng.randn(2, 32, 64, 64) * 12 + rng.uniform(-90, 60, (1, 32, 1, 1))
         ).astype(np.float32)
    bn = port_resnet.ConvBN(3, 32, 1, train_form=True).bn.train()
    # Flax's momentum 0.997 and epsilon 1e-5
    assert bn.momentum == pytest.approx(0.003) and bn.eps == 1e-5
    bn.momentum = 1.0               # the running statistics = the batch's
    bn(torch.from_numpy(x))
    want = x.astype(np.float64).var(axis=(0, 2, 3))
    port_err = np.abs(bn.running_var.numpy() / want - 1).max()
    assert port_err <= 1e-6, port_err
    flax_bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.0,
                                epsilon=1e-5)
    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    _, upd = flax_bn.apply(flax_bn.init(jax.random.key(0), nhwc), nhwc,
                           mutable=["batch_stats"])
    flax_err = np.abs(np.asarray(upd["batch_stats"]["var"]) / want - 1).max()
    assert flax_err > 10 * port_err, (flax_err, port_err)
