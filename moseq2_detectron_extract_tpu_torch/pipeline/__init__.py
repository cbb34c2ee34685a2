'''Per-chunk steps of the extraction pipeline: device inference and instance
selection.'''
