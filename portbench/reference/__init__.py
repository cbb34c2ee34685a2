'''Plain PyTorch references that the checks hold the program against.'''
