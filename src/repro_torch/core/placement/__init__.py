from repro_torch.core.placement.static import (
    allocate_budget_by_imbalance,
    calculate_imbalance,
    determine_replicas,
    generate_placement,
    static_expert_placement,
)
from repro_torch.core.placement.dynamic import DynamicScheduler, SchedulerConfig
from repro_torch.core.placement.migration import MigrationPlan, plan_migration

__all__ = [
    "allocate_budget_by_imbalance", "calculate_imbalance", "determine_replicas",
    "generate_placement", "static_expert_placement", "DynamicScheduler",
    "SchedulerConfig", "MigrationPlan", "plan_migration",
]
