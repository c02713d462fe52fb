"""Data of the port: dataset metadata, the COCO-format top-down dataset and
its evaluation, the host loader (native or cv2 JPEG decode), and training
augmentation and preprocessing."""
from .coco_index import CocoIndex
from .dataset_info import DatasetInfo
from .loader import TopDownLoader
from .topdown import TopDownDataset

# datasets whose own classes (list jsons, video sequences, part fields) are
# not ported yet
_NOT_PORTED = ('mpii', 'mpii_trb', 'coco_wholebody', 'posetrack18', 'jhmdb')


def topdown_dataset_cls(name):
    """Dataset name -> top-down dataset class (counterpart of
    vitpose_tpu/data/__init__.py:10-20). COCO-format datasets use
    TopDownDataset; the others raise until their classes are ported."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f'the {name!r} dataset class is not ported yet (ROADMAP.md queue '
            '1 item 6)')
    return TopDownDataset
