"""Data layer of the port: dataset discovery, label codecs, augmentation and
batching. The host decodes PNGs; flip, crop and normalize run on the device
(``data.augment``, ``ops.cuda.preprocess``)."""


def build_dataset(dataset: str, data_dir: str, image_size: tuple[int, int],
                  split: str = "train"):
    """Dataset factory keyed by ``DataConfig.dataset`` (the JAX package's
    ``data.build_dataset``). ``split`` selects the labeled split to iterate
    (``train_images``): Cityscapes has ``train`` and ``val``; KITTI road's
    testing split has no public GT, so only ``train`` is valid there."""
    if dataset in ("kitti_road", "synthetic"):
        if split != "train":
            raise ValueError(
                f"KITTI road has no labeled {split!r} split (testing GT is "
                "withheld by the benchmark); only 'train' is available")
        from semanticsegmentation_tensorflow_tpu_torch.data.kitti import (
            KittiRoadDataset,
        )
        return KittiRoadDataset(data_dir, image_size=image_size)
    if dataset == "cityscapes":
        from semanticsegmentation_tensorflow_tpu_torch.data.cityscapes import (
            CityscapesDataset,
        )
        return CityscapesDataset(data_dir, split=split, image_size=image_size)
    raise ValueError(f"unknown dataset {dataset!r}")
