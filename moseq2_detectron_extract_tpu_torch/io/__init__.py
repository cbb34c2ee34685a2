'''Session IO of the port: raw depth reads, sessions, timestamps and the
TIFF caches of ROI discovery, in numpy and the standard library.'''
