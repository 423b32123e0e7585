"""Dataset factory (counterpart of neumesh_tpu/dataio/__init__.py): the
DTU type, wrapped in the paint dataset with data.paint_dataset."""
from __future__ import annotations


def get_data(args, return_val: bool = False, val_downscale: float = 4.0,
             **overwrite_cfgs):
    """The dataset (a PaintDataset over it with data.paint_dataset), or
    with return_val the (train, val) pair, which differ only in their
    downscale."""
    dataset_type = args.data.get("type", "DTU")
    if dataset_type != "DTU":
        raise NotImplementedError(f"unknown dataset type {dataset_type}")
    from .dtu import SceneDataset
    cfgs = {
        "scale_radius": args.data.get("scale_radius", -1),
        "downscale": args.data.downscale,
        "data_dir": args.data.data_dir,
        "train_cameras": False,
        "split": args.data.get("split", "entire"),
        "intrinsic_from_cammat": args.data.get("intrinsic_from_cammat",
                                               False),
        "cam_file": args.data.get("cam_file", None),
    }
    cfgs.update(overwrite_cfgs)
    if return_val:
        return (SceneDataset(**cfgs),
                SceneDataset(**dict(cfgs, downscale=val_downscale)))
    dataset = SceneDataset(**cfgs)
    if not args.data.get("paint_dataset", False):
        return dataset
    from .paint import PaintDataset
    return PaintDataset(dataset)
