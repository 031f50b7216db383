"""The two-stage ranker (port of ``rank/``): candidate dumps from a retriever,
labelled per-user candidate groups, and the neural LambdaRank re-ranker."""
