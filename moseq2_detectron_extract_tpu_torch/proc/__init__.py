'''Feature processing of selected detection windows (clean, moments) and the
host-side instance tracker.'''
