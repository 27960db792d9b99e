"""Host-side data: synthetic graphs, the relation-bucketed graph format and
artifact IO."""
