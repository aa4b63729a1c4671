"""Core: RWSADMM updates, flat parameter layout, random-walk control plane."""
