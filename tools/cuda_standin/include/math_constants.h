#pragma once
#include <cmath>
#define CUDART_INF_F INFINITY
#define CUDART_INF ((double)INFINITY)
#define CUDART_NAN_F NAN
#define CUDART_NAN ((double)NAN)
