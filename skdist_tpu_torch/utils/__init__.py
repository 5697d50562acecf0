"""Host-side helpers of the port: validation, device resolution, CV
splitters and parameter grids (the card's machine has no scikit-learn),
and memory budgets."""
