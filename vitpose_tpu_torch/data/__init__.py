"""Data of the port: dataset metadata, the top-down datasets (COCO format,
MPII, MPII-TRB, COCO-WholeBody) and their evaluation, the host loader
(native or cv2 JPEG decode) with the ViTPose+ multi-dataset mixture, and
training augmentation and preprocessing."""
from .coco_index import CocoIndex
from .dataset_info import DatasetInfo, available_datasets
from .loader import MultiDatasetLoader, TopDownLoader
from .mpii import MpiiDataset, MpiiTrbDataset
from .topdown import TopDownDataset
from .wholebody import WholeBodyDataset

# video datasets whose classes come with the model families that use them
_NOT_PORTED = ('posetrack18', 'jhmdb')


def topdown_dataset_cls(name):
    """Dataset name -> top-down dataset class (counterpart of
    vitpose_tpu/data/__init__.py:10-20): MPII and MPII-TRB read list and
    TRB jsons, COCO-WholeBody evaluates per part, every other dataset is
    COCO-format (TopDownDataset)."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f'the {name!r} dataset class is not ported yet (ROADMAP.md queue '
            '1 item 12d: only CNN and PoseWarper configs use it)')
    return {'mpii': MpiiDataset, 'mpii_trb': MpiiTrbDataset,
            'coco_wholebody': WholeBodyDataset}.get(name, TopDownDataset)
