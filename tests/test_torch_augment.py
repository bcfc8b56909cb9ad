"""The port's training input path against the JAX package on the CPU: the
augment (flip + crop in uint8, then normalize), the preprocess kernel's
plain version against the Pallas augment in interpret mode, the synthetic
KITTI fixtures, the dataset and the batch loader. Every comparison is bit
for bit: the paths are integer indexing plus one f32 subtract and one f32
divide (or multiply by the same f32 reciprocal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsegmentation_tensorflow_tpu.data import (
    KittiRoadDataset as JaxKitti, generate_synthetic_kitti as jax_generate,
)
from semanticsegmentation_tensorflow_tpu.data.augment import (
    make_augment_fn as jax_make_augment_fn, sample_augment_params,
)
from semanticsegmentation_tensorflow_tpu.data.palette import (
    encode_labels as jax_encode_labels,
)
from semanticsegmentation_tensorflow_tpu.data.pipeline import (
    BatchLoader as JaxLoader, class_pixel_counts as jax_class_pixel_counts,
)
from semanticsegmentation_tensorflow_tpu.ops.pallas.preprocess import (
    make_pallas_augment_fn,
)
from semanticsegmentation_tensorflow_tpu_torch.data import build_dataset
from semanticsegmentation_tensorflow_tpu_torch.data.augment import (
    make_augment_fn, sample_augment_params as port_sample,
)
from semanticsegmentation_tensorflow_tpu_torch.data.palette import encode_labels
from semanticsegmentation_tensorflow_tpu_torch.data.pipeline import (
    BatchLoader, class_pixel_counts,
)
from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
    generate_synthetic_kitti,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.preprocess import (
    make_preprocess_augment_fn, preprocess_normalize,
)

MEAN, STD = (123.68, 116.779, 103.939), (58.393, 57.12, 57.375)


def _batch(n=4, h=32, w=48, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (n, h, w, 3), np.uint8),
            "label": rng.integers(0, 2, (n, h, w)).astype(np.int32),
            "valid": rng.random((n, h, w)) > 0.2}


def _params(key, batch, crop):
    n, h, w = batch["label"].shape
    return [torch.from_numpy(np.array(a)) for a in
            sample_augment_params(key, n, h, w, crop)]


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("crop,flip", [((24, 40), True), ((24, 40), False),
                                       (None, True)])
def test_augment_matches_jax_bit_for_bit(crop, flip):
    """Given the (flip, oy, ox) of JAX's sample_augment_params, the port's
    augment equals make_augment_fn's output under the same key."""
    batch = _batch()
    key = jax.random.key(7)
    # eager, as the JAX package's own augment tests run it (under jit XLA
    # may turn the divide by the constant std into a reciprocal multiply)
    want = jax_make_augment_fn(MEAN, STD, crop, flip)(
        key, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = make_augment_fn(MEAN, STD, crop, flip).apply(tb, *_params(key, batch, crop))
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("flip", [True, False])
def test_preprocess_plain_matches_pallas_interpret(flip):
    """The preprocess kernel's plain version (what the CPU runs) equals
    make_pallas_augment_fn in interpret mode, bytes and all."""
    batch = _batch(seed=1)
    key = jax.random.key(3)
    want = make_pallas_augment_fn(MEAN, STD, (24, 40), flip, interpret=True)(
        key, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    aug = make_preprocess_augment_fn(MEAN, STD, (24, 40), flip)
    before = preprocess_normalize.launches
    got = aug.apply(tb, *_params(key, batch, (24, 40)))
    assert preprocess_normalize.launches == before  # plain version on the CPU
    _assert_batches_equal(got, want)


def test_augment_draws_from_its_generator():
    """The draws come from the explicit generator: same seed, same batch;
    flips are fair coins and offsets stay inside the image."""
    tb = {k: torch.from_numpy(v) for k, v in _batch(n=64, seed=2).items()}
    aug = make_augment_fn(MEAN, STD, (24, 40))
    a = aug(torch.Generator().manual_seed(5), tb)
    b = aug(torch.Generator().manual_seed(5), tb)
    _assert_batches_equal(a, {k: v.numpy() for k, v in b.items()})
    flip, oy, ox = port_sample(torch.Generator().manual_seed(0), 4000, 32, 48,
                               (24, 40))
    assert 0.45 < flip.float().mean().item() < 0.55
    assert oy.min() == 0 and oy.max() == 8 and ox.min() == 0 and ox.max() == 8
    with pytest.raises(ValueError, match="color_jitter"):
        make_augment_fn(MEAN, STD, color_jitter=(0.2, 0.2))
    with pytest.raises(TypeError):
        preprocess_normalize(tb["image"].float(), flip[:64], oy[:64], ox[:64],
                             (24, 40), MEAN, STD)


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "preprocess"])
def test_augment_crops_each_data_rank_of_the_global_batch(kernel):
    """On a data grid (2 ranks, each its half of a global batch of 4) the
    flips and crop offsets are drawn for the global batch and each rank
    crops its own images: rank r's augmented batch equals images 2r, 2r+1
    of the one-process augment, bit for bit (the plain augment and the
    preprocess kernel's plain version); a grid that splits rows refuses the
    crop."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.preprocess import (
        make_preprocess_augment_fn,
    )
    from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import (
        Grid, use_grid,
    )

    make = make_preprocess_augment_fn if kernel else make_augment_fn
    aug = make(MEAN, STD, crop_size=(24, 40))
    tb = {k: torch.from_numpy(v) for k, v in _batch(n=4, seed=3).items()}
    whole = aug(torch.Generator().manual_seed(9), tb)
    for rank in range(2):
        with use_grid(Grid(data=2, spatial=1, rank=rank)):
            mine = aug(torch.Generator().manual_seed(9),
                       {k: v[2 * rank:2 * rank + 2] for k, v in tb.items()})
        for k in whole:
            assert torch.equal(mine[k], whole[k][2 * rank:2 * rank + 2]), (rank, k)
    with use_grid(Grid(data=1, spatial=2, rank=0)), \
            pytest.raises(ValueError, match="splits rows"):
        aug(torch.Generator().manual_seed(9), tb)


def test_synthetic_dataset_and_loader_match_jax(tmp_path):
    """The same seed writes the same synthetic KITTI tree; the port's
    dataset decodes it as the JAX package's does; BatchLoader's host
    batches (seeded shuffle, edge pad with valid=0, wrap-padded remainder)
    equal the JAX BatchLoader's over two epochs; class_pixel_counts too."""
    hw = (30, 50)
    jdir = jax_generate(str(tmp_path / "jax"), n_train=5, n_test=1, h=hw[0],
                        w=hw[1], seed=4)
    pdir = generate_synthetic_kitti(str(tmp_path / "port"), n_train=5,
                                    n_test=1, h=hw[0], w=hw[1], seed=4)
    jds = JaxKitti(jdir, image_size=hw)
    pds = build_dataset("kitti_road", pdir, hw)
    for jp, pp in zip(jds.train_images, pds.train_images):
        for a, b in zip(jds.load_example(jp), pds.load_example(pp)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(class_pixel_counts(pds, 2),
                                  jax_class_pixel_counts(jds, 2))

    jl = JaxLoader(jds, 2, pad_multiple=32, seed=3, drop_remainder=False)
    pl_ = BatchLoader(pds, 2, pad_multiple=32, seed=3, device="cpu",
                      drop_remainder=False)
    for _ in range(2):
        jb, pb = list(jl._host_epoch()), list(pl_._host_epoch())
        assert len(jb) == len(pb) == 3 == pl_.steps_per_epoch()
        for a, b in zip(jb, pb):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert pb[-1]["valid"][1].sum() == 0      # the wrapped example is invalid
    assert pb[0]["image"].shape == (2, 32, 64, 3)


def test_loader_epoch_yields_the_host_batches():
    """epoch() hands out the host batches as tensors on the device (the
    CPU here), in order, and re-raises a failure of the decode thread; a
    grid whose data ranks do not divide the batch raises."""

    class Fixed:
        train_images = [f"im{i}" for i in range(5)]

        def load_example(self, path):
            i = int(path[2:])
            return (np.full((4, 6, 3), i, np.uint8), np.full((4, 6), i % 2, np.int32),
                    np.ones((4, 6), bool))

    want = list(BatchLoader(Fixed(), 2, 8, seed=1, device="cpu")._host_epoch())
    got = list(BatchLoader(Fixed(), 2, 8, seed=1, device="cpu").epoch())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), w[k])

    class Broken(Fixed):
        def load_example(self, path):
            raise OSError("corrupt PNG")

    with pytest.raises(OSError, match="corrupt"):
        list(BatchLoader(Broken(), 2, 8, device="cpu").epoch())
    from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import Grid

    with pytest.raises(ValueError, match="data ranks"):  # 3 images over 2 ranks
        BatchLoader(Fixed(), 3, device="cpu", mesh=Grid(data=2, spatial=1, rank=0))


def test_label_codec_and_dataset_factory():
    gt = np.array([[[255, 0, 0], [255, 0, 255], [0, 0, 0]]], np.uint8)
    for a, b in zip(encode_labels(gt), jax_encode_labels(gt)):
        np.testing.assert_array_equal(a, b)
    cs = build_dataset("cityscapes", "x", (8, 8), split="val")   # ported since
    assert (cs.split, cs.image_size, cs.test_images) == ("val", (8, 8), [])
    with pytest.raises(FileNotFoundError, match="leftImg8bit/val"):
        cs.train_images
    with pytest.raises(ValueError):
        build_dataset("kitti_road", "x", (8, 8), split="val")
