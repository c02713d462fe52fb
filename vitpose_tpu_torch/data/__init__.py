"""Data of the port: dataset metadata, the top-down datasets (COCO format,
MPII, MPII-TRB, COCO-WholeBody, PoseTrack18, Sub-JHMDB) and their evaluation, the host loader
(native or cv2 JPEG decode) with the ViTPose+ multi-dataset mixture, and
training augmentation and preprocessing."""
from .coco_index import CocoIndex
from .dataset_info import DatasetInfo, available_datasets
from .jhmdb import JhmdbDataset
from .loader import MultiDatasetLoader, TopDownLoader
from .mpii import MpiiDataset, MpiiTrbDataset
from .posetrack import PoseTrackDataset
from .topdown import TopDownDataset
from .wholebody import WholeBodyDataset


def topdown_dataset_cls(name):
    """Dataset name -> top-down dataset class (counterpart of
    vitpose_tpu/data/__init__.py:10-20): MPII and MPII-TRB read list and
    TRB jsons, COCO-WholeBody evaluates per part, PoseTrack18 per video
    sequence, Sub-JHMDB by PCK and tPCK; every other dataset is
    COCO-format (TopDownDataset)."""
    return {'mpii': MpiiDataset, 'mpii_trb': MpiiTrbDataset,
            'coco_wholebody': WholeBodyDataset,
            'posetrack18': PoseTrackDataset,
            'jhmdb': JhmdbDataset}.get(name, TopDownDataset)
