'''Traffic drivers: one per kind of work a cell drives through the program.'''
