"""Parallelism taxonomy (reference: service/parallel/par_type.h)."""

import enum


class ParType(enum.Enum):
    NONE = "none"
    AUTO_DP = "auto_dp"          # batch-dim data parallelism found by planner
    SHARDING = "sharding"        # tensor/model sharding
    PEARL = "pearl"              # ZeRO-style variable split (reference name)
    DP_SHARDING = "dp_sharding"  # hybrid DP + sharding
    PIPELINE = "pipeline"        # ILP-cut pipeline stages
    ALLREDUCE = "allreduce"
    SPMD = "spmd"
    # Strategies the reference lacks; first-class here (SURVEY.md §5.7):
    SEQUENCE = "sequence"        # ring-attention / Ulysses context parallelism
    EXPERT = "expert"            # MoE expert parallelism
