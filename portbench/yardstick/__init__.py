'''The measuring stick: traffic generation, peaks, operation and byte counts, trace reduction.'''
