"""The paper's own workload configuration: SSB ETL dataflows (§5).

`--arch ssb-etl` selects the ETL benchmark path rather than an LM; sizes
scale the lineorder fact table (paper used 1-8 GB ~ 13-107M rows)."""
from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class ETLConfig:
    name: str = "ssb-etl"
    lineorder_rows: int = 2_000_000      # ~150 MB columnar; scale up to match paper
    customers: int = 30_000
    suppliers: int = 2_000
    parts: int = 20_000
    num_splits: int = 8                  # m  (paper's best: 8 pipelines)
    pipeline_degree: int = 8             # m'
    chunk_rows: int = 262_144
    #: operator backend for the heavy components ("torch" on the card,
    #: "torch_cpu" or the "numpy" reference — see core/backend/); consumed
    #: via ``engine_options()``
    backend: str = "torch"
    queries: tuple = ("Q1.1", "Q2.1", "Q3.1", "Q4.1")

    def engine_options(self, **overrides):
        """OptimizeOptions preconfigured from this workload config —
        including the operator backend — for OptimizedEngine/StreamingEngine.
        Keyword overrides win."""
        from ..core.engine import OptimizeOptions    # deferred (light module)
        kw = dict(num_splits=self.num_splits,
                  pipeline_degree=self.pipeline_degree,
                  chunk_rows=self.chunk_rows,
                  backend=self.backend)
        kw.update(overrides)
        return OptimizeOptions(**kw)


CONFIG = ETLConfig()
SMOKE_CONFIG = ETLConfig(name="ssb-etl-smoke", lineorder_rows=50_000,
                         customers=2_000, suppliers=200, parts=1_000,
                         num_splits=4, pipeline_degree=4, chunk_rows=16_384)
