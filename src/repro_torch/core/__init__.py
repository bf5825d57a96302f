"""AU-NMF core: the update rules, the BPP solver, the error from
byproducts, the serial iteration and the solver engine."""
