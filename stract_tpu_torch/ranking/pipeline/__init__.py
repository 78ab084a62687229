from .candidate import RankedCandidate
from .recall import RecallStage
from .precision import PrecisionStage
from .pipeline import RankingPipeline, NUM_PIPELINE_RANKING_RESULTS, NUM_RESULTS_PER_PAGE
