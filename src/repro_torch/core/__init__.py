"""Host-side core: sparse formats, preprocessing, launch schedules, SpMM."""
