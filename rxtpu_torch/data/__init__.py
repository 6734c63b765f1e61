from rxtpu_torch.data.pack import PackStore, write_raw_pack
from rxtpu_torch.data.pipeline import Pipeline, device_prefetch
from rxtpu_torch.data.records import (
    MetadataIndex, WellRecord, build_plate_groups, get_celltype, load_metadata,
    read_metadata_csvs, split_by_experiment, stratified_split,
)
from rxtpu_torch.data.stats import load_stats, stats_table

__all__ = [
    "MetadataIndex", "PackStore", "Pipeline", "WellRecord", "build_plate_groups",
    "device_prefetch", "get_celltype", "load_metadata", "load_stats",
    "read_metadata_csvs", "split_by_experiment", "stats_table", "stratified_split",
    "write_raw_pack",
]
