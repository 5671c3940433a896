from repro_torch.data.feedback_store import (FeedbackStore,  # noqa: F401
                                             FeedbackTriple)
from repro_torch.data.pipeline import (SyntheticLM, batches,  # noqa: F401
                                       dirichlet_clients)
